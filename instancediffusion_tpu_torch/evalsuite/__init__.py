"""Evaluation on the port (counterpart of `instancediffusion_tpu/evalsuite`):
the COCO generation program, PiM and attribute binding."""
