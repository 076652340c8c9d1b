"""Training steps (the port of ``weather_unet_tpu/train``)."""
