"""instancediffusion_tpu_torch.nn"""
