"""Evaluation of the weather transfer (the port of ``weather_unet_tpu/evaluation``)."""
