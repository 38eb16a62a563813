"""Device ops of the PyTorch port: stats, validation and the uniform-layout
QC step, each with a plain torch version beside its CUDA kernel."""
