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
* ``cli.common`` -- ``load_transfer``, ``load_estimator`` (reference
                    ``.pt`` or JAX-package msgpack), ``load_step_estimator``
                    and the CLIs' data and image helpers;
* ``cli.serve``  -- the HTTP server and its request ``Batcher``;
* ``cli.*``      -- the GAN and supervised training CLIs, the inference
                    CLIs (``demo``, ``inf_*``) and the eval CLIs
                    (``eval_*``);
* ``evaluation`` -- transfer-consistency evaluation over a ``WeatherTransfer``
                    and an estimator or classifier;
* ``core``       -- train-time generators, torch Adam, train states;
* ``data``       -- datasets, the imbalance sampler, loader-thread
                    augmentation, ``BatchLoader``, the GPU prefetch;
* ``train``      -- the GAN combined train step and its evaluation step
                    (``gan``), the trainer loop (``loops``), checkpoints
                    (``.pt``, and flax msgpack without flax), summaries and
                    preemption handling;
* ``parallel``   -- data parallelism over ``torch.distributed``: the
                    launcher and its env contract (``launch``), the plan,
                    placement and collectives (``mesh``).

The package imports ``torch`` and never ``jax`` or ``weather_unet_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU and without an explicit device they raise.  Under a process group
the default device is this rank's card (or the CPU where the launcher put
the ranks there).
"""

from weather_unet_tpu_torch._device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
