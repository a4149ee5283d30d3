"""instancediffusion_tpu_torch.utils"""
