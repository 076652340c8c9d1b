"""PyTorch/CUDA port of the weather-transfer cUNet serving path and of the
frozen ResNet-101 estimator/classifier path.

The JAX package ``weather_unet_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find:

* ``ops``        -- AdaIN statistics, the 2x align-corners upsample, conv/pool;
* ``kernels``    -- hand-written CUDA kernels for Hopper (``csrc/*.cu``) with
                    their plain PyTorch versions and launch counters;
* ``models``     -- ``ConditionalUNet`` and ``ResNet`` (``ResNet101``) with
                    the reference state_dict names;
* ``compat``     -- reference ``.pt`` loading and JAX-variable conversion;
* ``api``        -- ``WeatherTransfer`` (translate / translate_u8 / ...);
* ``cli.common`` -- ``load_transfer``, ``load_estimator``;
* ``cli.serve``  -- the request ``Batcher``;
* ``evaluation`` -- transfer-consistency evaluation over a ``WeatherTransfer``
                    and an estimator or classifier.

The package imports ``torch`` and never ``jax`` or ``weather_unet_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU and without an explicit device they raise.
"""

from weather_unet_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
