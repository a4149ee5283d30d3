"""The plain reference that decides `correct`: float32 PyTorch, no kernel,
no cache, no batching across requests. Its modules are frozen copies of
the port's plain routes (`instancediffusion_tpu_torch`), taken so that a
later change to the port cannot move its own yardstick; they import
nothing of the port or of JAX. `pipeline` holds the request-level
functions; `core.precision("fp8")` gives the control."""
