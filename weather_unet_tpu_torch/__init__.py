"""PyTorch/CUDA port of the weather-transfer cUNet serving path, the frozen
ResNet-101 estimator/classifier path and the GAN training path.

The JAX package ``weather_unet_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find:

* ``ops``        -- AdaIN statistics, the 2x align-corners upsample,
                    conv/pool, spectral norm, dropout, losses, inits;
* ``kernels``    -- hand-written CUDA kernels for Hopper (``csrc/*.cu``) with
                    their plain PyTorch versions and launch counters;
* ``models``     -- ``ConditionalUNet``, ``SNDisc`` and ``ResNet``
                    (``ResNet101``) with the reference state_dict names;
* ``compat``     -- reference ``.pt`` loading and JAX-variable conversion;
* ``api``        -- ``WeatherTransfer`` (translate / translate_u8 / ...);
* ``cli.common`` -- ``load_transfer``, ``load_estimator``,
                    ``load_step_estimator`` and the CLIs' data helpers;
* ``cli.serve``  -- the request ``Batcher``;
* ``cli.train_transfer_est`` / ``cli.train_transfer_cls`` -- the GAN
                    training CLIs;
* ``evaluation`` -- transfer-consistency evaluation over a ``WeatherTransfer``
                    and an estimator or classifier;
* ``core``       -- train-time generators, torch Adam, train states;
* ``data``       -- datasets, the imbalance sampler, loader-thread
                    augmentation, ``BatchLoader``, the GPU prefetch;
* ``train``      -- the GAN combined train step and its evaluation step
                    (``gan``), the trainer loop (``loops``), checkpoints,
                    summaries and preemption handling.

The package imports ``torch`` and never ``jax`` or ``weather_unet_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU and without an explicit device they raise.
"""

from weather_unet_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
