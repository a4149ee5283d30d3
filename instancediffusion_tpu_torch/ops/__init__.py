"""instancediffusion_tpu_torch.ops"""
