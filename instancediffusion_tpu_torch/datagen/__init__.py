"""Training-data generation on the port (counterpart of
`instancediffusion_tpu/datagen`): the labeling pipeline, its backends and
COCO to training records."""
