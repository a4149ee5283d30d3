"""instancediffusion_tpu_torch.samplers"""
