"""instancediffusion_tpu_torch.models"""
