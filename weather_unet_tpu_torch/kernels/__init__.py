"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper sends a CPU tensor to the plain version and a CUDA tensor
to its kernel (or raises); each counts its kernel launches in a module-level
integer ``launches``.

* ``adain``      (K1) -- replaces ``weather_unet_tpu/kernels/adain_pallas.py``
* ``upsample``   (K2) -- replaces ``weather_unet_tpu/kernels/upsample_pallas.py``
* ``upconv``     (K3) -- replaces ``weather_unet_tpu/kernels/upconv_pallas.py``
* ``bottleneck`` (K4) -- replaces ``weather_unet_tpu/kernels/bottleneck_pallas.py``
"""
