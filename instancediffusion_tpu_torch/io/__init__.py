"""instancediffusion_tpu_torch.io"""
