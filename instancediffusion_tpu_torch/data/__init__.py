"""instancediffusion_tpu_torch.data"""
