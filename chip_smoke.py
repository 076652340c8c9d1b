#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving, estimator and GAN training
paths, of its learning over many steps and its resume of a JAX training
run, of its trainer and training CLI, of its data runtime and supervised
pretraining, of its serving entry points (msgpack checkpoints, the HTTP
server, the inference and eval CLIs), of FID / IS and the exported serving
artifact, of the reference-surface ops and the dataset tools, of data,
tensor and spatial parallelism, and of the AOT tier's CUDA graphs, on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. env      -- torch/CUDA versions, the card's name and power limit.
2. build    -- compiles csrc/*.cu with nvcc (kernels/_build.py), timed.
3. kernels  -- each kernel against its plain PyTorch version on the card, in
               float32 and bfloat16: K1 (AdaIN), K2 (2x upsample) and K3
               (upsample+conv) at the cUNet's decoder shapes (B=16, 256x256
               input) and one odd shape; K1 also at a plane too large to
               hold on chip (its re-reading path), K2 also at a full-width
               site whose rows are not 16-byte aligned (its scalar path);
               K1 and K2 under every plan (``adain_plans``,
               ``upsample_plans``), each timed on the device at the main
               sites, where each is also asserted (torch.profiler) to run
               exactly one device kernel a call.  K1/K2 records carry three times:
               "ms" the wall time of one wrapper call (CUDA events around
               the Python call, host time included), "device_ms" (=
               "launch_only_ms") the kernel's own duration from
               torch.profiler (CUPTI), "cold_l2_ms" the same while rotating
               among input copies of more than 64 MB (the 50 MB L2 cannot
               hold the input from one call to the next).  K3 in every
               combination of cb /
               scale+shift / relu; K4 (identity bottleneck) at one site per
               ResNet-101 layer (B=16, 224x224 input) and one odd shape,
               with folded weights from random running statistics and
               non-zero biases; one backward per autograd.Function.
               K3 and K4 run their tensor-core kernels where the rule
               (takes_tensor_cores) sends them (asserted from their
               counters; the records name the plan that ran and the
               TFLOP/s reached), K4 also once under every other plan that
               fits the site (tile rows x width, "/n" for a cluster of n
               blocks sharing the tile, "k64" for reduction chunks of 64):
               bfloat16 on bf16 operands, float32 as split float32 (three
               TF32 mmas a product), whose records add the CUDA-core kernel
               they replace, called directly ("cuda_core_ms", its error
               and bound) and take their bound on the 3xTF32 rate
               (495/3 TFLOP/s); the odd K3 shape (C = 8) and the odd K4
               shape in float32 (P = 16) run the CUDA-core kernels.
               Tolerances (max abs error):
                 K1, K2 and K4 also at the GAN step's sites (decoder at a
               224x224 input, batch 8; ResNet-101 at batch 8).
               float32:  1e-5 * max(1, max|plain|) -- float32 reassociation
                           over up to 4608 products (cuDNN's TF32 is off
                           here), and in the split float32 forms ~2^-21 a
                           product;
                 bfloat16: 2^-6 * max(1, max|plain|) -- the plain chain
                           rounds to bf16 after each op, the kernel once (K4
                           and its plain version round at the same points
                           and differ by the order in which the tensor cores
                           sum, which can move a rounding by one bf16 step).
4. e2e      -- a seeded reference-format .pt bundle loaded through
               WeatherTransfer.load in the plain, use_pallas (K1 + K2) and
               fuse_upconv (K3) configurations; translate and translate_u8 at
               B=16, 256x256.  Asserts 3 launches per forward of each kernel
               of the configuration; float32 kernel configurations within
               MAE 1e-5 of the plain one; bfloat16 within MAE 1e-3 of its own
               float32;
               the plain configuration on the card within MAE 1e-5 of the
               same model on the CPU at a small input.  Prints img/s at B=16
               and batch-1 p50 latency of each configuration, and of the
               float32 ones again with cuDNN's TF32 on (PyTorch's default,
               what float32 serving gets).  Then B=1 (the first input,
               whose condition is standard normal): the bfloat16-vs-own-
               float32 MAE of the plain and use_pallas configurations,
               printed (ROADMAP.md section 3 records it), and B=3 (the
               first three inputs, padded to a bucket of 4) the same;
               use_pallas against plain in float32 within MAE 1e-5.
5. serve    -- a Batcher(max_batch=16) over the fuse_upconv transfer answers
               24 uint8 224x224 requests from 8 threads, each within 1 uint8
               step of a direct translate_u8.
6. estimator -- a seeded ResNet-101 (random weights, random BatchNorm
               parameters and running statistics) saved as a state-dict .pt
               and loaded through load_estimator; fused_resnet_eval (K4)
               built from the same weights; B=16, 224x224.  Asserts 29 K4
               launches per fused forward, in bfloat16 all 29 of them on the
               tensor cores; float32 fused logits within
               2e-4 * max(1, max|logits|) of the module's eval forward;
               bfloat16 logits (plain and fused) within 0.25 * max(1,
               max|logits|) of the float32 module (bf16 keeps 8 bits
               through 101 layers of a random network), the fused ones no
               further from it than twice the plain ones; the plain module
               on the card within 2e-4 * max(1, max|logits|) of the same
               module on the CPU at 64x64.  Prints img/s of the plain
               forward under torch.inference_mode and with autograd on
               (load_estimator's apply as it is), and of the fused one.
               Then class_transfer_consistency over two batches of 8 at
               224x224 with the use_pallas transfer and the fused
               classifier (K1, K2 and K4 in one path): every prediction in
               range and equal to the plain classifier's except where the
               top two logits are closer than the tolerance.
7. gan      -- the GAN combined step (train/gan.py) at full width: the
               7.8 M-parameter cUNet, the SNDisc and the seeded ResNet-101
               of phase 6 through load_estimator; 224x224, batch 8, est mode
               (GanConfig's defaults), conditions from the estimator.
               The K4-routed estimator's logits (29 K4 launches without
               autograd, none with it) against the plain module's on one
               batch of 8, at phase 6's tolerances.
               Parity at dropout 0: one step from one seed in each of the
               eight configurations (float32 / bfloat16, plain / use_pallas
               generator -- K1 + K2, 6 launches each --, plain / K4-routed
               estimator), compared in pairs that differ in one thing.
               Float32 (TF32 off), use_pallas against plain under each
               route: losses within rel 1e-4; Adam's two moments (the
               gradient and its square) within 1e-4 of the network's
               largest element plus twice the float32 floor (how far the
               plain step's moments move when its images move by one or
               two roundings: G's gradient sums cancel, so ~1e-3 at full
               width); updated parameters within the Adam sign-flip bound
               (fewer than 0.5% of the elements beyond 5e-5, none beyond
               2.2 * lr); u within 1e-4.  The K4 route against the plain
               one (plain generator) to the same bars plus twice
               route_sensitivity (loss_con divides by the distance between
               a sample's two conditions, so the route's condition error
               moves the step by up to its ratio to that distance).
               Bfloat16: use_pallas against the float32 plain generator
               under the same route, no further from it than twice the
               bfloat16 plain generator is, plus 2^-7 (losses; the
               moments' relative L2 error); the K4 route against the plain
               one within that bar plus twice its bfloat16
               route_sensitivity.  The use_pallas step at 32x32, batch 2,
               with a depth-(1, 1, 1, 1) estimator on the card against the
               CPU, to the float32 use_pallas
               bars.  Steady state at
               dropout 0.3 in float32 and bfloat16 (float32 master
               weights), plain and use_pallas generator, plain and
               K4-routed estimator (its stop-gradient forwards through
               fused_resnet_eval, 58 K4 launches a step; the forward on G's
               output through the plain module): 2 warm-up, 5 timed, 1
               D-only and 1 profiled step each, asserting the launches of
               every step (6 K1 + 6 K2 a combined step, 3 + 3 a D-only
               one), finite losses, every u advanced and the step counts.
               Prints the median step ms (host clock around a synchronized
               step), img/s, peak memory, the device time of one step
               (union of its kernels from torch.profiler) over the median
               step, its kernel count and top kernels by device time, and
               the estimator's share (its two stop-gradient
               forwards and the forward + input backward on G's output,
               timed apart).  Then the evaluation step once at batch 8:
               finite metrics, fakes (8, 8, 3, 224, 224), u not moved.
7a. dynamics -- examples/synthetic_weather_demo_torch.py (the port's GAN
               step on a synthetic task whose frozen estimator is a linear
               readout of mean colour; use_pallas G: K1 and K2) at 64x64,
               batch 32, bfloat16, 120 steps, eager and with aot_cache (the
               step a CUDA graph): both runs pass the G-learns bars of
               tests/test_training_dynamics.py (readback below 0.60 of the
               untrained G's and 0.45 of the no-transfer baseline,
               reconstruction L1 below 0.5); prints each report's readback
               and img/s (over the run so far, and each window's alone:
               the graphed run's first holds its capture, whose seconds
               are printed), the card's SM clock, power and utilization
               range from nvidia-smi during each run, and the first step
               where the runs' d_loss or g_loss part by more than 1e-3
               relative; K1 and K2 counted
               in the eager run, and in the graphed run from the replayed
               graphs' nodes (6 + 6 a step).
7b. jax_resume -- the GAN trainer at full width (use_pallas G, SNDisc, the
               K4-routed ResNet-101 of phase 6; 224x224, batch 8, est mode,
               dropout 0), float32 (TF32 off) and bfloat16: two steps, the
               state written in the JAX package's GanTrainState layout
               (gan_tree_to_jax, save_checkpoint_file) as
               ckpt_s0000000002.msgpack in a fresh save_dir, fresh trainers
               resumed from it eagerly and with aot_cache, and step 3 of
               each against the uninterrupted trainer's on the same batch.
               The load equals the saved state bit for bit except weight_v
               (JAX keeps no v: recomputed from u, and no forward reads
               it); the float32 eager step 3 equals the uninterrupted one
               bit for bit (cuDNN's deterministic algorithms; the
               uninterrupted step 3 is run twice from one state, and a
               tensor may differ only where those two differ, then held
               to the float32 bar); the graphed float32 step within phase 7's
               float32 bars (the floor measured here, the sign-flip bound
               of step 3, 2.2 * lr * sqrt(3)); bfloat16 eager and graphed
               within phase 7's bfloat16 bars against the uninterrupted
               bfloat16 step.  K1 6, K2 6, K4 58 on each resumed step (the
               counters, and the replayed graph's nodes).
8. train    -- the trainer (train/loops.py) and the est training CLI at
               full width, 224x224, batch 8, the seeded ResNet-101 through
               cli/common.py::load_step_estimator (K4 route in bfloat16, the
               module in float32).  First a line of what the host has
               (Pillow, pandas, TensorBoard, libjpeg).  Then: the trainer's
               first step at float32 (TF32 off), dropout 0, against
               make_gan_step called by hand on the same batches, to phase
               7's float32 bars; the trainer's launches a step (K1 6, K2 6,
               K4 58 in bfloat16 and 0 in float32 a combined step, K1 and
               K2 3 a D-only one); trainer img/s in bfloat16 and float32
               (10 steps over an in-memory BatchLoader) beside the bare
               step timed the same way on batches already on the card and
               beside phase 7's, and the device busy share of 3 profiled
               steps;
               one async checkpoint save (blocking and total ms, file size),
               restored bit for bit, and the export_torch bundle loaded
               through load_transfer (strict).  Where Pillow is present, on
               96 seeded 256x256 JPEGs: the est CLI in --image_only mode
               (bf16, --augmentation, 4 workers, 2 epochs of 8 steps,
               --export_torch) and, with pandas, in frame mode (one epoch,
               evaluation every 4 steps), counting launches and the
               trainer's own img/s windows; the loader alone (HostAugment,
               4 workers) in img/s and whether it keeps up with the bf16
               trainer; and the CLI in a child process stopped by SIGTERM
               once its step-3 checkpoint lands (exit 0, a checkpoint at the
               stop step), then relaunched in this process ("resumed
               from", the fast-forward, a final global step of 2 epochs x
               8).
               Without Pillow, fit() over the in-memory loaders instead.
               One bf16 trainer step with device_augment (both batches
               warped on the card, resized crop and jitter): K1 6, K2 6,
               K4 58, finite losses.
9. supervised -- the native runtime (a line of what the host has: c++,
               jpeglib.h, whether -ljpeg links, the build's mode and
               seconds; the runtime must be built), the decode cache, the
               device augment and supervised pretraining.  The native
               augment against the device augment on the card, same affine
               and factors, 257x257 -> 224x224, 8 images: max abs
               <= 1/255 + 1e-3 (uint8 rounding); the device augment on the
               card against the CPU with the same draws: <= 1e-5.
               augment_batch ms at B=64.  Loader img/s alone (96 seeded
               256x256 JPEGs, 257x257 decode, --augmentation, 4 threads):
               HostAugment, NativeAugment, CachedAugment(NativeAugment)
               filling (epoch 1) and reading (epoch 2, every read a hit).
               train_supervised card vs CPU: a depth-(1, 1, 1, 1) ResNet at
               32x32, B=4, float32, one classifier and one estimator step:
               losses rel 1e-4, BN statistics 1e-5, parameters within the
               Adam sign-flip bound.  The frozen backbone (--pre_trained):
               conv1-layer3 bit-identical after 3 bf16 steps of ResNet-101.
               Full width (ResNet-101, 5 outputs, 42.5 M parameters,
               224x224, B=64), bf16 and float32 (TF32 off), 2 warm-up and 5
               timed steps through train_supervised each: the estimator step
               over in-memory batches, the NativeAugment loader and the
               device warp (augment_cfg), the classifier step in memory;
               step ms (host clock, synchronized after each step), img/s,
               peak memory, and the device busy share (device time of one
               bare in-memory step over the step ms).  The estimator CLI
               on the JPEGs with a pandas frame (--decode_cache
               --augmentation --dtype bf16 -bs 8, 2 epochs of 8 steps),
               then in a child process stopped by SIGTERM after its third
               step and relaunched here ("resumed from", the fast-forward,
               final step 16); the classifier CLI over a class-path split
               (2 steps).  No K1-K4 launch anywhere in the phase.
10. serving_cli -- the serving entry points at full width (the 7.8
               M-parameter cUNet, phase 6's seeded ResNet-101), float32
               with TF32 off unless named, on a world of 32 seeded 256x256
               JPEGs, a Flickr frame over them (16 train, 16 test rows of
               one station) and an i2w split (5 classes x 4 test photos).
               Checkpoints: the cUNet as a reference .pt and as the JAX
               trainer's msgpack GAN layout (the port's flax-free writer),
               the ResNet-101 as a state-dict .pt and as msgpack; the
               state dicts that load_transfer / load_estimator read from
               the two files must be bit-equal; msgpack read ms and MiB.
               The HTTP server (cli/serve.py, 127.0.0.1, --input_size 224
               --max_batch 16, warmup on) on the msgpack file, float32 and
               --bf16: 96 POSTs of the JPEGs from 8 client threads (in a
               child process, off the server's interpreter lock) mixing
               class=<name>, class=<index> and cond=<vector>; every answer
               200, image/jpeg, 224x224; float32 answers within a mean of
               1 uint8 step of the same JPEG encode (quality 95) of the
               direct translate_u8; 400 for a bad cond, 404 for a bad
               route, 403 for /profile without --profile_dir, and with it
               a Chrome trace holding the traffic's kernels; K1 and K2
               launch 3 times per device forward, warmup included.
               Prints requests/s, client p50/p90 ms, the Batcher's
               batch_ms p50/p90 and mean batch size, and the device busy
               share (the same traffic again under torch.profiler).  The
               nine inference and eval CLIs in this process with real argv
               at --input_size 224: each ends without error, writes what
               its JAX counterpart writes and launches K1 and K2 3 times
               per cUNet forward (none in the estimator-only CLIs); prints
               each one's images/s.  inf_transfer_c and
               eval_class_transfer again with --device cpu on a 4-image
               subset (1 image, a depth cut: CUTS): saved pictures
               within 1 uint8 step of the card's,
               labels equal where the top two logits are more than 1e-3
               apart.
11. eval_export -- FID and IS through Inception-v3 at full width (seeded
               random weights, BatchNorm calibrated on one batch), on two
               directories of 64 seeded 256x256 JPEGs: pool3 features at
               299x299 (resized in the model), batch 50, float32 (TF32 off)
               and bfloat16; the card's float32 features within a relative
               L2 error of 1e-4 of the CPU's (8 images), bfloat16 within
               0.25 of float32; FID finite in both.  Prints img/s (feature
               function and the network alone), peak memory, the device
               busy share of a forward, the host's sqrtm seconds and
               scipy's warnings (the Frechet distance in float32 only: one
               host sqrtm).  The fid_score CLI's --save-stats of one
               directory (the statistics within 1e-5 of the in-process
               ones) and that .npz against the other (the FID within 1e-6
               of the in-process one; a second host sqrtm), the
               inception_score CLI (input
               224, batch 32, 10 splits) on a torchvision-layout head; each
               one's images/s; no K1-K4 launch.  Then the use_pallas cUNet
               at full width, 256x256: export_serving --check in float32 and
               bfloat16 (export seconds, artifact MiB, load ms, every tensor
               of the programs on the card), ExportedTransfer at batches 1
               and 16 against the live WeatherTransfer: MAE <= 1e-5
               against the live model in its dtype (the export must not
               change the function), a bfloat16 program no further from
               the live float32 model than the live bfloat16 model is
               (+1e-5; that distance itself is recorded), translate_u8
               within 1 step of the live model in its dtype;
               3 K1 + 3 K2 a program forward (counters, and kernel names
               under torch.profiler), img/s at batch 16 of the artifact and
               the live forward in turns; serve --artifact (float32) answers
               16 POSTs from 4 client threads of a child process (200,
               image/jpeg, within a mean of 1 step of the direct
               translate_u8 through the same encode, 3 K1 + 3 K2 a batch).
11a. surface -- the reference-surface ops and modules that no model path
               calls, and the dataset tools.  UpsampleBox (2x upsample,
               affine-less BatchNorm) at the cUNet decoder's three
               use_pallas upsample inputs of a 256x256, B=16 forward
               (K2_SITES upsample3/2/1), float32 (TF32 off) and bfloat16,
               eval and train mode: use_pallas (K2, one launch a call,
               added to the main-path totals) against plain within
               1e-5 * max|y| (float32; the running statistics to 1e-5) and
               2^-6 * max|y| (bfloat16); device ms of each route.  The
               upsample's gather and shift forms (ops/resize.py) at the
               same inputs: float32 within 1e-5 * max of K2 and of
               F.interpolate, bfloat16 within 2^-6 * max of their own
               float32; device ms of gather, shift, K2 and F.interpolate.
               DoubleConvDown at the upsample1 input (128 -> 256 channels)
               and ConditionalNorm at the upsample2 input, card against
               CPU, float32, eval and train: relative 1e-5 (outputs and
               running statistics).  packed_dropout at (8, 256, 56, 56),
               rate 0.3: the keep share within 4 sigma of thresh/256, kept
               values exactly x * 256/thresh, one mask a seed and two
               seeds two masks.  The deterministic utils_misc functions:
               card equal to CPU.  The host tools over a fresh serving
               world, in this process: preprocess split-i2w, split-flickr
               and remove-gray (one gray and one missing photo dropped)
               writing what the same data/preprocess.py calls return,
               pkl_viewer on each output, write_image_summary over 3 image
               events of a SummaryWriter (one JPEG an event), plot_signals
               (a PNG where matplotlib is present, else its refusal naming
               matplotlib; recorded).
11b. parallel -- data parallelism (parallel/launch.py, parallel/mesh.py),
               the ranks in child processes of tools/dp_train_torch.py;
               the card's compute mode must be Default.  (a) NCCL at
               world size 1 through the launcher: the est trainer, 3
               steps at 224x224, B=8, f32 (TF32 off, cuDNN
               deterministic), dropout 0, K1, K2 and the K4-routed
               estimator; its checkpoint bit-equal to the run without
               the launcher.  (b) Two gloo ranks sharing cuda:0, alone on
               it, the same run at global B=8: the ranks' checkpoints
               byte-equal, no refused allocation, each step against the
               one-process step (a child process) from rank 0's state
               before it on the ranks' inputs joined, at the bars of
               phase tensor_parallel (b) (the float32 floor also from the
               step with its weights moved by one rounding: at B=4 a rank
               runs other cuDNN and cuBLAS engines than B=8, which
               re-rounds every conv) plus twice the K4 route's
               sensitivity to the split (its bf16 timing run is cut:
               CUTS).  (c) Two gloo ranks of train_estimator,
               2 steps at 224x224, global B=64, f32, each step against the
               one-process step on the ranks' joined rows (losses rel
               1e-4; BN statistics and the sign-flip bound, each plus
               twice that step's float32 floor).  (d) WeatherTransfer
               with two replicas on cuda:0 against one, f32 and bf16, 256,
               B=16: MAE <= 1e-5, 6 K1 and 6 K2 launches; serve
               --data_parallel answers 16 POSTs.  Every rank's K1, K2 and
               K4 launches join the main-path totals.
11c. tensor_parallel -- tensor parallelism (parallel/tp.py): every
               double conv split Megatron-style over a model axis of 2.
               (a) A seeded reference .pt through WeatherTransfer.load(
               plan=make_mesh(["cuda:0", "cuda:0"], data=1, model=2),
               tensor_parallel=True) with use_pallas, 256x256, B=16, the
               two shards in two threads: float32 (TF32 off) within MAE
               1e-5 of the unsharded use_pallas forward, bfloat16 within
               1e-3 of its own float32, translate_u8 within 1 of the
               unsharded wire, 7 model-group sums and 3 K1 and 3 K2
               launches a forward on each shard, each shard's weight MiB
               beside the whole model's; the float32 split through the AOT
               tier (aot_cache with tensor_parallel: each shape's program
               the eager split forward) bit-equal to the untiered split, 2
               programs, no capture, no file; then data=2, model=2 over
               cuda:0 four times, 8 rows a data row.  (b) Two gloo ranks
               sharing cuda:0 running train_transfer_est --tensor_parallel 2
               (through tools/dp_train_torch.py --mode est_cli, the
               estimator K4-routed) at 224x224, B=8, 3 steps in float32,
               from the JPEGs' directory with a relative image root (the
               augmentation streams are keyed on the paths, so the rows
               are the same in every run; their digest is recorded):
               the ranks' gathered checkpoints byte-equal, each step held
               to the one-process step from rank 0's state before it on
               the same inputs and dropout seed at the bars of phase
               parallel (b) (the float32 floor also from the step with
               its weights moved by one rounding, which re-rounds every
               conv as the split does; the parity steps in a child
               process, where no allocation may be refused: a refused
               cuDNN workspace runs another engine, fault F1; its step 1
               taken again in this process after the earlier phases must
               leave the same bytes unless an allocation was refused), K1,
               K2 and K4 launches a step and rank, no refused allocation
               in a rank; the ranks alone on the card (its bf16 timing run
               is cut: CUTS).  (c) The TP=2 checkpoint resumes in this
               process without tensor parallelism bit-equal on load and
               takes one more step at the same bars.  (d) Four gloo ranks, data=2, model=2, 2
               steps at global B=8, dropout 0.3: the ranks of a data row
               load the same rows and draw the same masks, the rows
               differ; the four checkpoints byte-equal.  Every rank's K1,
               K2 and K4 launches join the main-path totals.
11d. spatial -- spatial partitioning (parallel/spatial.py): image height
               cut over a model axis at multiples of 16 rows.  K1's split
               form (local plane statistics, the mean and M2 each at its
               own scale; the apply launch's merge of the shards'
               statistics bit for bit merge_plane_stats, also at n = 2, 3,
               4 and 14 uneven shards under every plan, and its
               modulation, also against the plain statistics) and K2's
               row window against their plain versions at every shard
               shape below, float32 and bfloat16, timed at shard 0 of
               256x256, B=16, degree 2 (K1's pair under torch.profiler:
               its two kernels, the exchange's stand-in on a line of its
               own, and exactly these three device kernels a call), K2's
               window also as one F.grid_sample (float32).  (a) The
               use_pallas cUNet from the seeded .pt through SpatialModel
               over cuda:0 named 2 and 4 times (threads), 256x256,
               B=16: float32 (TF32 off) within MAE 1e-5 of the
               unsharded forward, bfloat16 within 1e-3 of
               its own float32, 3 of each split launch a shard and no
               whole-plane K1 or whole-image K2, 20 exchanges a forward;
               224x224 at degree 4 (rows 48/64/48/64) in float32.  (b) Two
               gloo ranks sharing cuda:0 (tools/dp_train_torch.py --spatial
               2) take 3 combined GAN steps at 224x224, B=8, est mode,
               dropout 0.3, the K4-routed estimator on the gathered rows,
               float32 (TF32 off, cuDNN deterministic): the ranks' states
               byte-equal, 6 of each split launch and 58 K4 launches a step
               and rank, no refused allocation; each step against the
               one-process step (a child process) from rank 0's state
               before it on the ranks' rows joined, at phase
               tensor_parallel (b)'s bars; then 3 bf16 steps timed (step
               ms, exchange ms).  The split launches are reported as
               "adain_split" and "upsample_rows" on the kernels line.
12. aot      -- the AOT tier (core/aot.py) at full width, each program a
               CUDA graph held to its eager counterpart: the use_pallas
               cUNet at 256x256 through WeatherTransfer(aot_cache=) at
               B=1, 4 and 16 in float32 (TF32 off) and bfloat16 (MAE <=
               1e-5 from eager; img/s graph against eager in turns; the
               device ms, kernel count and top kernels of a forward each
               way; first-call seconds; a second WeatherTransfer on the
               same directory captures its 3 buckets again, and nothing is
               written there), one graphed fuse_upconv
               (K3) forward at B=16 bf16; serve --aot_cache (bf16,
               224x224, max_batch 16) against a server without the tier,
               96 POSTs from 8 clients in turns (plain, tier, tier,
               plain), start-up seconds of a tiered and a plain server
               in this process; as a restart makes them, each after one
               untimed plain start in a young process (two processes,
               plain then tier and tier then plain, so each tiered start
               holds its process's first captures), run right after phase
               build while this process holds nothing on the card: the
               tier's median within 0.3 s of the plain one's, no file
               written; the GAN trainer
               with aot_cache at 224x224, B=8, est mode, use_pallas G,
               K4-routed bf16 estimator: bf16 step ms (median of 10 in
               turns with the eager trainer), img/s, device busy share,
               kernels; float32 (TF32 off, dropout 0) graphed steps 1 and
               2 against eager ones from the same state (copied into the
               graph's tensors in place) at phase 7's bars, the sign-flip
               bound of step k 2.2 * lr * sqrt(k), the float32 floor of
               each step measured here; a graphed dropout forward's masks
               from the registered generator (seeds 1, 2, 1: two masks,
               seed 1 twice equal and equal to eager); fit under
               profile_dir (the trace names K1, K2, K4); the supervised
               ResNet-101 estimator step at B=64, 224x224: bf16 step ms
               and busy share against eager in turns, one float32 graphed
               step against eager (losses rel 1e-4, BN statistics 1e-5,
               the sign-flip bound), train_supervised(aot_cache=) over 3
               batches; the doctor's main with --json --probe returns 0
               naming the card (in this process).  Every replay's
               K1-K4 launches are counted by kernel name under
               torch.profiler (a replay runs no Python wrapper, so the
               launch counters count eager launches only); no capture may
               build a cached plan, table or scale anew (lru-cache misses
               during capture).
13. kernels -- the summary line of every ported kernel (launches on the main
               paths of phases 4-11c, and "graph_replay_launches" counted
               by name in phase 12's replays; error, times and bound over
               one serving forward's sites and, under "gan_step_forward",
               over one GAN generator (K1, K2) or estimator (K4)
               forward's).

Every phase line carries "t_s", the seconds since the script started; the
line before the kernels line ("phase": "total") gives the script's seconds
and the depth cuts that paid for phases 7a and 7b.
The last line is {"ok": true, "device": {...}}.  Float32 comparisons run
with TF32 off for cuDNN convs and matmuls (set at the start of the run).
"""

from __future__ import annotations

import contextlib
import copy
import glob
import hashlib
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SEED = 0
PEAK_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,              # CUDA cores, no tensor cores
              torch.bfloat16: 989e12}            # tensor cores, dense
# float32-accurate work on the tensor cores: split float32, three TF32 mmas
# (495 TFLOP/s dense) a product -- the rate of K3's and K4's float32 forms
PEAK_FLOPS_3XTF32 = 495e12 / 3
TOL_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
DTYPES = (torch.float32, torch.bfloat16)
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# decoder sites of the cUNet at a 256x256 input, batch 16 (serving), and at
# a 224x224 input, batch 8 (the GAN step, "gan_*")
K1_SITES = {"adain3": (16, 512, 32, 32), "adain2": (16, 256, 64, 64),
            "adain1": (16, 128, 128, 128), "odd": (2, 8, 5, 7),
            "beyond_chip": (2, 8, 256, 256),   # re-reading path
            "gan_adain3": (8, 512, 28, 28), "gan_adain2": (8, 256, 56, 56),
            "gan_adain1": (8, 128, 112, 112)}
K3_SITES = {"up3": (16, 512, 32, 32, 256), "up2": (16, 256, 64, 64, 128),
            "up1": (16, 128, 128, 128, 64), "odd": (2, 8, 5, 7, 4)}
K2_SITES = {"upsample3": (16, 512, 32, 32), "upsample2": (16, 256, 64, 64),
            "upsample1": (16, 128, 128, 128), "odd": (2, 8, 5, 7),
            "unaligned": (16, 128, 128, 127),  # scalar path
            "gan_upsample3": (8, 512, 28, 28),
            "gan_upsample2": (8, 256, 56, 56),
            "gan_upsample1": (8, 128, 112, 112)}
# one identity block per ResNet-101 layer at a 224x224 input, batch 16
# (the estimator phase) and batch 8 (the GAN step's estimator, "gan_*")
K4_SITES = {"layer1": (16, 256, 56, 56), "layer2": (16, 512, 28, 28),
            "layer3": (16, 1024, 14, 14), "layer4": (16, 2048, 7, 7),
            "odd": (2, 64, 5, 7),
            "gan_layer1": (8, 256, 56, 56), "gan_layer2": (8, 512, 28, 28),
            "gan_layer3": (8, 1024, 14, 14), "gan_layer4": (8, 2048, 7, 7)}
# sites of each kernel on its main paths, with their count in one forward:
# serving (and the estimator phase) ...
MAIN_SITES = {"adain": {"adain3": 1, "adain2": 1, "adain1": 1},
              "upsample": {"upsample3": 1, "upsample2": 1, "upsample1": 1},
              "upconv": {"up3": 1, "up2": 1, "up1": 1},
              "bottleneck": {"layer1": 2, "layer2": 3, "layer3": 22,
                             "layer4": 2}}
# ... and the GAN step (K3 does not run in train mode)
GAN_SITES = {"adain": {"gan_adain3": 1, "gan_adain2": 1, "gan_adain1": 1},
             "upsample": {"gan_upsample3": 1, "gan_upsample2": 1,
                          "gan_upsample1": 1},
             "bottleneck": {"gan_layer1": 2, "gan_layer2": 3,
                            "gan_layer3": 22, "gan_layer4": 2}}
LOGIT_TOL = 2e-4      # float32 logits, relative to max(1, max|logits|)
# bfloat16 logits against the float32 module: the seeded random network
# amplifies a rounding error some 300x on its way to the logits (float32's
# 6e-8 arrives as 2e-5), so bfloat16's 2^-9 arrives as O(0.1)
LOGIT_TOL_BF16 = 0.25
START = time.perf_counter()
# depth cut from earlier phases to pay for phases dynamics and jax_resume
CUTS = ["eval_inception: the Frechet distance (a 2048x2048 host sqrtm) in "
        "float32 only, not bfloat16",
        "eval_clis: no directory-against-directory fid_score run; the .npz "
        "run's FID is held to the in-process one, the saved stats to the "
        "in-process statistics",
        "serving_card_vs_cpu: 1 image on the CPU, not 4",
        "eval_export_parity: the artifact at batches 1 and 16, not 1, 3 "
        "and 16",
        "dynamics: 120 steps of the demo (its default is 2000)",
        "serving_cli: the demo CLI at 2 frames, not 5 (its GIF encode on "
        "the host took ~25 s)",
        "aot_doctor: the doctor's main in this process, not a child "
        "process",
        "parallel: no bf16 timing run of the two data-parallel ranks "
        "(phase tensor_parallel times two split ranks' bf16 steps)",
        "tensor_parallel: no bf16 timing run of the two split ranks "
        "(phase spatial times two spatial ranks' bf16 steps)"]


def emit(obj) -> None:
    if "phase" in obj:      # seconds since the script started
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def kernel_records(fn, reps: int = 1, tries: int = 5) -> dict:
    """{kernel name: [duration us, ...]} of the GPU work of ``reps`` calls
    of ``fn``, as torch.profiler (CUPTI) records it.  A profile can come
    back with no device record at all (seen on the H100 after many
    profiles in a row); it is taken again, up to ``tries`` times.  {} if
    every one was empty."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            return by_name
    return {}


def per_call(by_name: dict, reps: int) -> dict:
    """{kernel name: (device ms a call, launches a call)} from
    ``kernel_records``: the median duration times its launches a call
    (rounded, at least 1), so a profile that loses some records still
    counts each kernel of the call once."""
    out = {}
    for name, us in by_name.items():
        n = max(1, round(len(us) / reps))
        out[name] = (float(np.median(us)) * n / 1e3, n)
    return out


def device_kernels(fn, reps: int = 1, tries: int = 5):
    """(names, device ms per call) of the GPU work ``fn`` launches, from the
    kernel durations torch.profiler (CUPTI) records, no host time
    (``kernel_records``, ``per_call``).  ([], None) if every profile was
    empty."""
    by_name = kernel_records(fn, reps, tries)
    if not by_name:
        return [], None
    ms = sum(t for t, _ in per_call(by_name, reps).values())
    return [n for n, us in by_name.items() for _ in us], ms


def device_ms(fn, reps: int = 10, warmup: int = 2):
    for _ in range(warmup):
        fn()
    return device_kernels(fn, reps)[1]


def cold_l2_ms(fn, x, reps: int = 10):
    """Device ms of ``fn(x')`` rotating among copies x' of x that hold more
    than 64 MB together, so no call finds its input in the 50 MB L2."""
    copies = [x.clone() for _ in range(min(64, -(-(64 << 20)
                                                 // nbytes(x))))]
    it = itertools.cycle(copies)
    return device_ms(lambda: fn(next(it)), reps=max(reps, len(copies)))


def one_kernel(name, fn, failures, calls: int = 5, tries: int = 5):
    """The device kernels of ``calls`` calls of ``fn``, which must be one
    kernel a call.  A profile can lose records, so a profile passes with
    exactly ``calls`` records of one name, fails outright with a second
    name or more records, and is taken again with fewer."""
    for _ in range(tries):
        names = device_kernels(fn, calls)[0]
        if len(set(names)) > 1 or len(names) > calls:
            break
        if len(names) == calls:
            return names[:1]
    failures.append(f"{name}: {len(names)} device kernels in {calls} calls "
                    f"({sorted(set(names))}), expected 1 a call")
    return names


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_3xtf32(n_bytes: int, flops: float) -> tuple:
    """``bound`` for a float32 form on the tensor cores."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_3XTF32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations (3xTF32)")


# the float32 tensor-core forms, each a kernel of the kernels line under a
# name of its own, and the module whose counter counts its launches
TF32_FORMS = {"bottleneck_3xtf32": "bottleneck", "upconv_3xtf32": "upconv"}


def tf32_counts(counters, zero=False):
    """The float32 tensor-core forms' launch counts (K4's and K3's
    ``f32_tensor_core_launches``); with ``zero`` set them to 0 first."""
    mods = {name: counters[k] for name, k in TF32_FORMS.items()}
    if zero:
        for m in mods.values():
            m.f32_tensor_core_launches = 0
    return {name: m.f32_tensor_core_launches for name, m in mods.items()}


def tf32_run(fn, counters, tf32_totals, want, what):
    """Run ``fn`` with the float32 forms' counts set to 0 just before it
    and read just after; they join ``tf32_totals`` and must equal ``want``
    (form -> launches)."""
    tf32_counts(counters, zero=True)
    out = fn()
    torch.cuda.synchronize()
    got = tf32_counts(counters)
    for name in got:
        tf32_totals[name] += got[name]
    if got != {name: want.get(name, 0) for name in got}:
        raise AssertionError(f"{what}: float32 tensor-core launches {got} "
                             f"!= {want}")
    return out


def on_main_path(kernel, site) -> bool:
    return site in MAIN_SITES[kernel] or site in GAN_SITES.get(kernel, {})


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def check(name, err, ref, dtype, failures) -> float:
    tol = TOL_REL[dtype] * max(1.0, float(ref.float().abs().max()))
    if not err <= tol:
        failures.append(f"{name}: max abs err {err} > tol {tol}")
    return tol


def phase_env():
    """Versions and the card; returns nvidia-smi's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return smi


def phase_build():
    from weather_unet_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{log.name}: " + " | ".join(regs), file=sys.stderr)
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(libs)})


def phase_kernels():
    """Each kernel against its plain version.  Returns per-kernel, per-dtype
    summaries over the three main-path sites."""
    import torch.nn.functional as F

    from weather_unet_tpu_torch.kernels import (
        adain as k1, bottleneck as k4, upconv as k3, upsample as k2)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    failures = []
    summary = {"adain": {}, "upsample": {}, "upconv": {}, "bottleneck": {}}
    for dt in DTYPES:
        for site, (b, c, h, w) in K1_SITES.items():
            x, y = randn(b, c, h, w, dtype=dt), randn(b, c * 4, dtype=dt)
            name = f"adain {site} {DT_NAME[dt]}"
            out = k1.adain_fused(x, y)
            ref = k1.adain_fused_ref(x, y)
            err = max_err(out, ref)
            tol = check(name, err, ref, dt, failures)
            main = on_main_path("adain", site)
            plan = k1.plan_adain(b, c, h, w, dt)
            plans = {}
            for pl in k1.adain_plans(b, c, h, w, dt):
                perr = max_err(k1.adain_kernel(x, y, 1e-5, pl), ref)
                check(f"{name} plan {pl['name']}", perr, ref, dt, failures)
                plans[pl["name"]] = {"max_abs_err": perr}
                if main:
                    plans[pl["name"]]["device_ms"] = device_ms(
                        lambda: k1.adain_kernel(x, y, 1e-5, pl), reps=5)
            rec = {"phase": "kernel", "kernel": "adain", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "plan": plan["name"], "max_abs_err": err, "tol": tol,
                   "device_kernels_per_call": one_kernel(
                       name, lambda: k1.adain_fused(x, y), failures)
                   if main else None,
                   "ms": time_ms(lambda: k1.adain_fused(x, y)),
                   "device_ms": device_ms(lambda: k1.adain_fused(x, y)),
                   "cold_l2_ms": cold_l2_ms(
                       lambda xx: k1.adain_fused(xx, y), x),
                   "plain_ms": time_ms(lambda: k1.adain_fused_ref(x, y)),
                   "library_ms": None, "plans": plans}
            rec["launch_only_ms"] = rec["device_ms"]
            rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, y, out),
                                                     6.0 * x.numel(), dt)
            emit(rec)
            summary["adain"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w, o) in K3_SITES.items():
            x = randn(b, c, h, w, dtype=dt)
            wt = (randn(o, c, 3, 3) / (9 * c) ** 0.5).to(dt)
            cb = randn(b, o, 2 * h, 2 * w, dtype=dt)
            sc = torch.rand(b, c, generator=gen, device="cuda") + 0.5
            sh = randn(b, c)
            combos = {}
            for use_cb in (False, True):
                for use_mod in (False, True):
                    for relu in (False, True):
                        kw = dict(cb=cb if use_cb else None,
                                  scale=sc if use_mod else None,
                                  shift=sh if use_mod else None, relu=relu)
                        out = k3.upsample2x_conv3x3(x, wt, **kw)
                        ref = k3.upsample2x_conv3x3_ref(x, wt, **kw)
                        err = max_err(out, ref)
                        key = f"cb={int(use_cb)},mod={int(use_mod)},relu={int(relu)}"
                        check(f"upconv {site} {DT_NAME[dt]} {key}", err, ref,
                              dt, failures)
                        combos[key] = err
            tc_before = k3.tensor_core_launches
            out = k3.upconv_block_fused(x, wt, cb, sc, sh, True)
            on_tc = k3.tensor_core_launches == tc_before + 1
            if on_tc != k3.takes_tensor_cores(dt, c):
                failures.append(f"upconv {site} {DT_NAME[dt]}: tensor cores "
                                f"{on_tc}, the rule says otherwise")
            ref = k3.upconv_block_ref(x, wt, cb, sc, sh, True)
            err = max_err(out, ref)
            tol = check(f"upconv {site} {DT_NAME[dt]}", err, ref, dt, failures)
            ms = time_ms(lambda: k3.upconv_block_fused(x, wt, cb, sc, sh, True))
            launch_ms = time_ms(lambda: k3.upconv_kernel(x, wt, cb, sc, sh,
                                                         True))
            plain_ms = time_ms(lambda: k3.upconv_block_ref(x, wt, cb, sc, sh,
                                                           True))
            flops = 2.0 * b * o * 4 * h * w * (9 * c + 1)
            moved = nbytes(x, wt, cb, sc, sh, out)
            bms, by = bound(moved, flops, dt)
            esize = x.element_size()
            rec = {"phase": "kernel", "kernel": "upconv", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w, o],
                   "max_abs_err": err, "tol": tol, "combos_max_abs_err": combos,
                   "ms": ms, "launch_only_ms": launch_ms,
                   "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "gflop": flops / 1e9,
                   "tflops": flops / launch_ms / 1e9,
                   "variant": ("tensor cores " + k3.plan_upconv(
                       c, o, esize=esize)["name"] if on_tc else "cuda cores")}
            if on_tc and dt == torch.float32:
                # the 3xTF32 form: bound on its own rate, and the CUDA-core
                # kernel it replaces, called directly, beside it
                rec["cuda_core_bound_ms"], rec["cuda_core_bound_by"] = bms, by
                rec["bound_ms"], rec["bound_by"] = bound_3xtf32(moved, flops)
                cc = k3.upconv_kernel(x, wt, cb, sc, sh, True,
                                      cuda_cores=True)
                rec["cuda_core_max_abs_err"] = max_err(cc, ref)
                check(f"upconv {site} float32 cuda cores",
                      rec["cuda_core_max_abs_err"], ref, dt, failures)
                rec["cuda_core_ms"] = time_ms(lambda: k3.upconv_kernel(
                    x, wt, cb, sc, sh, True, cuda_cores=True))
                del cc
            emit(rec)
            summary["upconv"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w) in K2_SITES.items():
            x = randn(b, c, h, w, dtype=dt)
            name = f"upsample {site} {DT_NAME[dt]}"
            # the plain result first, and alive while the kernel runs: the
            # kernel's output buffer cannot be memory that already held it
            ref = k2.upsample2x_fused_ref(x)
            out = k2.upsample2x_fused(x)
            err = max_err(out, ref)
            tol = check(name, err, ref, dt, failures)
            # a channels-last input is copied to NCHW by the wrapper
            err_cl = max_err(k2.upsample2x_fused(
                x.contiguous(memory_format=torch.channels_last)), ref)
            check(f"{name} channels_last", err_cl, ref, dt, failures)
            main = on_main_path("upsample", site)
            plan = k2.plan_upsample(b, c, h, w, dt)
            plans = {}
            for pl in k2.upsample_plans(b, c, h, w, dt):
                perr = max_err(k2.upsample_kernel(x, pl), ref)
                check(f"{name} plan {pl['name']}", perr, ref, dt, failures)
                plans[pl["name"]] = {"max_abs_err": perr, "smem": pl["smem"]}
                if main:
                    plans[pl["name"]]["device_ms"] = device_ms(
                        lambda: k2.upsample_kernel(x, pl), reps=5)
            rec = {"phase": "kernel", "kernel": "upsample", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "plan": plan["name"], "max_abs_err": err,
                   "channels_last_max_abs_err": err_cl, "tol": tol,
                   "device_kernels_per_call": one_kernel(
                       name, lambda: k2.upsample2x_fused(x), failures)
                   if main else None,
                   "ms": time_ms(lambda: k2.upsample2x_fused(x)),
                   "device_ms": device_ms(lambda: k2.upsample2x_fused(x)),
                   "cold_l2_ms": cold_l2_ms(k2.upsample2x_fused, x),
                   "plain_ms": time_ms(lambda: k2.upsample2x_fused_ref(x)),
                   "library_ms": time_ms(lambda: F.interpolate(
                       x, scale_factor=2, mode="bilinear",
                       align_corners=True)),
                   "plans": plans}
            rec["launch_only_ms"] = rec["device_ms"]
            rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, out),
                                                     8.0 * out.numel(), dt)
            emit(rec)
            summary["upsample"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w) in K4_SITES.items():
            p = c // 4
            x = randn(b, c, h, w, dtype=dt)
            wts = k4.fold_bottleneck(random_bottleneck_state(c, p, gen))
            wts = tuple(a.to(dt) if a.dim() > 1 else a for a in wts)
            if not all(float(a.abs().min()) > 0 for a in wts[1::2]):
                raise AssertionError("bottleneck biases must be non-zero")
            ref = k4.bottleneck_eval_reference(x, *wts)
            on_tc = k4.takes_tensor_cores(dt, c, p, h, w)
            f32_tc = on_tc and dt == torch.float32
            esize = x.element_size()
            # the model packs the tensor-core kernel's weights once
            # (fused_resnet_eval; float32 split), so the timed call takes
            # them packed
            args = ((k4.pack_bottleneck(*wts, dt, f32_tc),) if on_tc
                    else wts)
            tc_before = k4.tensor_core_launches
            out = k4.fused_bottleneck_eval(x, *wts)
            if (k4.tensor_core_launches - tc_before == 1) != on_tc:
                failures.append(f"bottleneck {site} {DT_NAME[dt]}: wrong "
                                f"kernel for the rule")
            err = max_err(out, ref)
            tol = check(f"bottleneck {site} {DT_NAME[dt]}", err, ref, dt,
                        failures)
            ms = time_ms(lambda: k4.fused_bottleneck_eval(x, *args))
            plain_ms = time_ms(lambda: k4.bottleneck_eval_reference(x, *wts))
            flops = 2.0 * b * h * w * (2 * c * p + 9 * p * p)
            moved = nbytes(x, out, *wts)
            bms, by = bound(moved, flops, dt)
            rec = {"phase": "kernel", "kernel": "bottleneck", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "launch_only_ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bms, "bound_by": by,
                   "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                   "variant": "cuda cores",
                   "nonzero_share": float((out != 0).float().mean())}
            if f32_tc:
                # the 3xTF32 form: bound on its own rate, and the CUDA-core
                # kernel it replaces, called directly, beside it
                rec["cuda_core_bound_ms"], rec["cuda_core_bound_by"] = bms, by
                rec["bound_ms"], rec["bound_by"] = bound_3xtf32(moved, flops)
                rec["cuda_core_max_abs_err"] = max_err(
                    k4.bottleneck_kernel(x, *wts), ref)
                check(f"bottleneck {site} float32 cuda cores",
                      rec["cuda_core_max_abs_err"], ref, dt, failures)
                rec["cuda_core_ms"] = time_ms(
                    lambda: k4.bottleneck_kernel(x, *wts))
            if on_tc:
                # every tile plan that fits, the chosen one first; the others
                # forced, checked, and timed at one repetition
                plans = k4.bottleneck_plans(b, c, p, h, w, esize=esize)
                rec["variant"] = "tensor cores " + plans[0]["name"]
                rec["plans"] = {}
                for plan in plans:
                    got = k4.bottleneck_tc_kernel(x, args[0], plan)
                    perr = max_err(got, ref)
                    check(f"bottleneck {site} plan {plan['name']}", perr, ref,
                          dt, failures)
                    rec["plans"][plan["name"]] = {
                        "max_abs_err": perr, "stages": plan["stages"],
                        "smem": plan["smem"],
                        "ms": ms if plan is plans[0] else time_ms(
                            lambda: k4.bottleneck_tc_kernel(x, args[0], plan),
                            reps=1, warmup=1)}
            emit(rec)
            summary["bottleneck"].setdefault(dt, {})[site] = rec
    failures += check_backward(k1, k2, k3)
    if failures:
        raise AssertionError("kernel checks failed:\n" + "\n".join(failures))
    return summary


def random_bottleneck_state(c, p, gen):
    """State dict of one identity bottleneck on the card: conv weights
    scaled to keep activations O(1), BatchNorm scale and running variance
    uniform in [0.5, 2), non-zero shift and running mean."""
    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device="cuda")

    def uniform(n):
        return torch.rand(n, generator=gen, device="cuda") * 1.5 + 0.5

    sd = {"conv1.weight": randn(p, c, 1, 1, std=(2.0 / c) ** 0.5),
          "conv2.weight": randn(p, p, 3, 3, std=(2.0 / (9 * p)) ** 0.5),
          "conv3.weight": randn(c, p, 1, 1, std=(2.0 / p) ** 0.5)}
    for name, n in (("bn1", p), ("bn2", p), ("bn3", c)):
        sd[f"{name}.weight"] = uniform(n)
        sd[f"{name}.bias"] = randn(n, std=0.3)
        sd[f"{name}.running_mean"] = randn(n, std=0.3)
        sd[f"{name}.running_var"] = uniform(n)
    return sd


def check_backward(k1, k2, k3):
    """Gradients through each autograd.Function (kernel forward, plain
    recompute backward) against autograd of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def leaf(*shape, lo=None):
        t = torch.randn(*shape, generator=gen, device="cuda")
        if lo is not None:
            t = t.abs() + lo
        return t.requires_grad_()

    failures = []
    cases = {
        "adain": ((leaf(4, 64, 16, 16), leaf(4, 256)),
                  lambda a: k1.adain_fused(*a), lambda a: k1.adain_fused_ref(*a)),
        "upsample": ((leaf(2, 16, 9, 12),),
                     lambda a: k2.upsample2x_fused(*a),
                     lambda a: k2.upsample2x_fused_ref(*a)),
        "upconv": ((leaf(2, 16, 8, 12), leaf(8, 16, 3, 3),
                    leaf(2, 8, 16, 24), leaf(2, 16, lo=0.5), leaf(2, 16)),
                   lambda a: k3.upconv_block_fused(*a, True),
                   lambda a: k3.upconv_block_ref(*a, True)),
    }
    for name, (args, fused, plain) in cases.items():
        g1 = torch.autograd.grad(torch.sin(fused(args)).sum(), args)
        g2 = torch.autograd.grad(torch.sin(plain(args)).sum(), args)
        errs = [max_err(a, b) / max(1.0, float(b.abs().max()))
                for a, b in zip(g1, g2)]
        emit({"phase": "backward", "kernel": name, "rel_err": errs,
              "tol": 1e-4})
        if not max(errs) <= 1e-4:
            failures.append(f"{name} backward: rel err {errs} > 1e-4")
    return failures


def tf32_want(counters, dt, kernel, sites):
    """Launches of ``kernel``'s float32 tensor-core form in one forward
    over ``sites`` (site -> count): the sites the rule sends there."""
    if dt != torch.float32:
        return 0
    return tc_want(counters, dt, kernel, sites)


def tc_want(counters, dt, kernel, sites):
    """Launches of ``kernel`` on the tensor cores in one forward over
    ``sites`` (site -> count), by the rule."""
    m = counters[kernel]
    if kernel == "upconv":
        return sum(n for s, n in sites.items()
                   if m.takes_tensor_cores(dt, K3_SITES[s][1]))
    return sum(n for s, n in sites.items() if m.takes_tensor_cores(
        dt, K4_SITES[s][1], K4_SITES[s][1] // 4, *K4_SITES[s][2:]))


def phase_e2e(path, counters, launch_totals, tf32_totals):
    """The three configurations end to end; returns the transfers by
    (configuration, dtype) for the later phases."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    rng = np.random.default_rng(SEED)
    b, size = 16, 256
    u8 = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
    conds[::4] = rng.standard_normal((len(conds[::4]), 5)).astype(np.float32)
    xf = WeatherTransfer.preprocess(u8)
    x_dev, c_dev = xf.cuda(), torch.from_numpy(conds).cuda()
    sd = torch.load(path, weights_only=True)["inference"]

    def build(config, dt):
        if config == "use_pallas":
            model = ConditionalUNet(5, dtype=dt, use_pallas=True)
            model.load_state_dict(sd, strict=True)
            return WeatherTransfer(model, device="cuda")
        return WeatherTransfer.load(path, dtype=dt, device="cuda",
                                    fuse_upconv=(config == "fuse_upconv"),
                                    use_pallas=False)

    expect = {"plain": {}, "use_pallas": {"adain": 3, "upsample": 3},
              "fuse_upconv": {"upconv": 3}}
    outs, wts = {}, {}
    for dt in DTYPES:
        for config in ("plain", "use_pallas", "fuse_upconv"):
            wt = wts[config, dt] = build(config, dt)
            for k in counters:
                counters[k].launches = 0
            # fuse_upconv in float32: K3's 3xTF32 form at its three sites
            n_tf32 = (tf32_want(counters, dt, "upconv",
                                MAIN_SITES["upconv"])
                      if config == "fuse_upconv" else 0)
            out_u8, out = tf32_run(
                lambda: (wt.translate_u8(u8, conds), wt.translate(xf, conds)),
                counters, tf32_totals, {"upconv_3xtf32": 2 * n_tf32},
                f"e2e {config} {DT_NAME[dt]}")
            torch.cuda.synchronize()
            got = {k: m.launches for k, m in counters.items()}
            want = {k: 2 * expect[config].get(k, 0) for k in counters}
            if got != want:
                raise AssertionError(f"{config} {DT_NAME[dt]}: launches {got}"
                                     f" != {want} (3 per forward)")
            for k in counters:
                launch_totals[k] += got[k]
            out_u8, out = out_u8.cpu().numpy(), out.float().cpu().numpy()
            if out.shape != (b, size, size, 3) or out_u8.shape != out.shape:
                raise AssertionError(f"{config}: shapes {out.shape} "
                                     f"{out_u8.shape}")
            if not np.isfinite(out).all():
                raise AssertionError(f"{config} {DT_NAME[dt]}: non-finite")
            step = np.abs(out_u8.astype(np.int16)
                          - WeatherTransfer.to_uint8(out).astype(np.int16))
            if step.max() > 1:
                raise AssertionError(f"{config}: translate_u8 differs from "
                                     f"to_uint8(translate) by {step.max()}")
            outs[config, dt] = (out, out_u8)
            ips, p50 = measure(wt, x_dev, c_dev, counters, launch_totals)
            rec = {"phase": "e2e", "config": config, "dtype": DT_NAME[dt],
                   "batch": b, "size": size, "launches_per_forward":
                   {k: v // 2 for k, v in got.items()},
                   "upconv_3xtf32_launches_per_forward": n_tf32,
                   "img_per_s": ips, "p50_ms_batch1": p50}
            if config != "plain":
                ref, ref_u8 = outs["plain", dt]
                rec["mae_vs_plain"] = float(np.abs(out - ref).mean())
                rec["u8_max_step_vs_plain"] = int(np.abs(
                    out_u8.astype(np.int16) - ref_u8.astype(np.int16)).max())
            if dt == torch.bfloat16:
                rec["mae_vs_own_float32"] = float(np.abs(
                    out - outs[config, torch.float32][0]).mean())
            emit(rec)
            if dt == torch.float32 and config != "plain" and not (
                    rec["mae_vs_plain"] <= 1e-5):
                raise AssertionError(f"{config} float32 MAE vs plain "
                                     f"{rec['mae_vs_plain']} > 1e-5")
            if dt == torch.bfloat16 and not rec["mae_vs_own_float32"] <= 1e-3:
                raise AssertionError(f"{config} bfloat16 MAE vs float32 "
                                     f"{rec['mae_vs_own_float32']} > 1e-3")
    # B=1 (the first input, whose condition is standard normal, as every
    # fourth row's) and B=3 (a bucket of 4, rows 0-2): printed, and held to
    # the float32 bar against plain only:
    # the 1e-3 bfloat16 bar is held at B=16 above (ROADMAP.md section 3,
    # the bfloat16 distance at B=1)
    rec = {"phase": "e2e_b1", "batch": 1, "size": size}
    b1 = {}
    for dt in DTYPES:
        for config in ("plain", "use_pallas"):
            b1[config, dt] = wts[config, dt].translate(
                xf[:3], conds[:3]).float().cpu().numpy()
    for config in ("plain", "use_pallas"):
        for n in (1, 3):
            rec[f"{config}_b{n}_bf16_vs_own_float32_mae"] = float(np.abs(
                b1[config, torch.bfloat16][:n]
                - b1[config, torch.float32][:n]).mean())
    for dt in DTYPES:
        rec[f"use_pallas_vs_plain_{DT_NAME[dt]}_mae"] = float(np.abs(
            b1["use_pallas", dt][:1] - b1["plain", dt][:1]).mean())
    emit(rec)
    if not rec["use_pallas_vs_plain_float32_mae"] <= 1e-5:
        raise AssertionError(f"e2e B=1: {rec}")
    # float32 serving as a user gets it: PyTorch's default lets cuDNN run
    # float32 convs in TF32 (the kernels' float32 forms stay float32-
    # accurate: split float32, three TF32 products)
    torch.backends.cudnn.allow_tf32 = True
    try:
        for config in ("plain", "use_pallas", "fuse_upconv"):
            ips, p50 = measure(wts[config, torch.float32], x_dev, c_dev,
                               counters, launch_totals)
            emit({"phase": "e2e_cudnn_tf32", "config": config,
                  "dtype": "float32", "batch": b, "size": size,
                  "img_per_s": ips, "p50_ms_batch1": p50})
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check_card_vs_cpu(sd)
    return wts


def measure(wt, x_dev, c_dev, counters, launch_totals):
    """img/s at the batch of x_dev, and batch-1 p50 latency in ms (host clock
    around a synchronized call)."""
    before = {k: m.launches for k, m in counters.items()}
    for _ in range(2):
        wt.translate(x_dev, c_dev)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        wt.translate(x_dev, c_dev)
    torch.cuda.synchronize()
    ips = n * x_dev.shape[0] / (time.perf_counter() - t0)
    lat = []
    for _ in range(12):
        t0 = time.perf_counter()
        wt.translate(x_dev[:1], c_dev[:1]).cpu()
        lat.append(time.perf_counter() - t0)
    for k, m in counters.items():
        launch_totals[k] += m.launches - before[k]
    return ips, float(np.median(lat[2:]) * 1e3)


def check_card_vs_cpu(sd):
    """The plain configuration on the card against the same model on the
    CPU, at a small input."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    rng = np.random.default_rng(SEED + 2)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    c = np.eye(5, dtype=np.float32)[[0, 3]]
    outs = []
    for dev in ("cpu", "cuda"):
        model = ConditionalUNet(5)
        model.load_state_dict(sd, strict=True)
        outs.append(WeatherTransfer(model, device=dev).translate(x, c)
                    .float().cpu().numpy())
    mae = float(np.abs(outs[0] - outs[1]).mean())
    emit({"phase": "e2e_card_vs_cpu", "shape": [2, 64, 64, 3], "mae": mae,
          "tol": 1e-5})
    if not mae <= 1e-5:
        raise AssertionError(f"card vs CPU MAE {mae} > 1e-5")


def phase_serve(wt, counters, launch_totals):
    from weather_unet_tpu_torch.cli.serve import Batcher

    rng = np.random.default_rng(SEED + 3)
    n, size = 24, 224
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    conds[1::3] = rng.standard_normal((len(conds[1::3]), 5)).astype(np.float32)
    direct = wt.translate_u8(imgs, conds).cpu().numpy()
    for m in counters.values():
        m.launches = 0
    batcher = Batcher(wt, max_batch=16)
    results = [None] * n

    def client(t):
        for i in range(t, n, 8):
            results[i] = batcher.submit(imgs[i], conds[i])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("Batcher clients did not finish in 300 s")
    stats = batcher.stats()
    batcher.close()
    for k, m in counters.items():
        launch_totals[k] += m.launches
    answered = sum(r is not None and r.shape == (size, size, 3)
                   and r.dtype == np.uint8 for r in results)
    worst = max(int(np.abs(r.astype(np.int16) - d.astype(np.int16)).max())
                for r, d in zip(results, direct))
    emit({"phase": "serve", "answered": answered, "of": n,
          "max_step_vs_direct": worst, "upconv_launches":
          counters["upconv"].launches, "stats": stats})
    if answered != n or worst > 1:
        raise AssertionError(f"Batcher: {answered}/{n} answered, max step "
                             f"{worst}")
    if counters["upconv"].launches != 3 * stats["batches"]:
        raise AssertionError("Batcher batches did not run K3 3 times each")


def make_estimator_checkpoint(path):
    """A seeded ResNet-101 saved as a state-dict .pt: random conv and fc
    weights, random BatchNorm scale and shift, and running statistics that
    are one batch's statistics (so activations stay O(1) through 101
    layers) perturbed at random per channel.  The last BatchNorm of each
    block gets a smaller scale, as zero-init-residual training leaves it:
    with scales around 1 there, float32 rounding alone moves this random
    network's logits by 2e-4 (against a float64 forward), the size of the
    bar the fused forward is held to."""
    from weather_unet_tpu_torch.models import Bottleneck, ResNet101
    from weather_unet_tpu_torch.models.common import BatchNorm2d

    gen = torch.Generator().manual_seed(SEED + 4)
    model = ResNet101(5, generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
            bn.momentum = 1.0           # running := this batch's statistics
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.uniform_(0.2, 0.6, generator=gen)
        model.cuda().train()
        model((torch.rand(16, 3, 224, 224, generator=gen) * 2 - 1).cuda())
        model.cpu().eval()
        for bn in bns:
            bn.momentum = 0.1
            n = bn.num_features
            bn.running_mean += (0.1 * bn.running_var.sqrt()
                                * torch.randn(n, generator=gen))
            bn.running_var *= torch.empty(n).uniform_(0.8, 1.25,
                                                      generator=gen)
    torch.save(model.state_dict(), path)


def ips_of(fn, batch, n=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return n * batch / (time.perf_counter() - t0)


def phase_estimator(path, transfer, counters, launch_totals, tf32_totals):
    """The frozen ResNet-101 through load_estimator (plain module) and
    through fused_resnet_eval (K4), then the class-transfer consistency
    evaluation over the use_pallas transfer and the fused classifier."""
    from weather_unet_tpu_torch.cli.common import load_estimator
    from weather_unet_tpu_torch.evaluation.transfer import (
        class_transfer_consistency)
    from weather_unet_tpu_torch.kernels import bottleneck as k4
    from weather_unet_tpu_torch.kernels.bottleneck import fused_resnet_eval

    def counted(fn, want):
        for m in counters.values():
            m.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in counters.items()}
        if got != {k: want.get(k, 0) for k in counters}:
            raise AssertionError(f"estimator path: launches {got} != {want}")
        for k in counters:
            launch_totals[k] += got[k]
        return out

    def rel(a, b):
        return max_err(a, b) / max(1.0, float(b.float().abs().max()))

    rng = np.random.default_rng(SEED + 5)
    b, size = 16, 224
    x = torch.from_numpy(rng.uniform(-1, 1, (b, size, size, 3))
                         .astype(np.float32)).cuda()
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    logits, fused_by_dt, plain_by_dt = {}, {}, {}
    for dt in DTYPES:
        plain = plain_by_dt[dt] = load_estimator(path, dtype=dt)
        fused = fused_by_dt[dt] = fused_resnet_eval(plain.model)
        got_plain = counted(lambda: plain(x), {})
        k4.tensor_core_launches = 0
        # float32: K4's 3xTF32 form wherever the rule sends a site
        want_f32 = tf32_want(counters, dt, "bottleneck",
                             MAIN_SITES["bottleneck"])
        got_fused = tf32_run(
            lambda: counted(lambda: fused(x_nchw), {"bottleneck": 29}),
            counters, tf32_totals, {"bottleneck_3xtf32": want_f32},
            f"estimator {DT_NAME[dt]}")
        want_tc = tc_want(counters, dt, "bottleneck", MAIN_SITES["bottleneck"])
        if k4.tensor_core_launches != want_tc:
            raise AssertionError(
                f"estimator {DT_NAME[dt]}: {k4.tensor_core_launches} of the "
                f"29 K4 launches ran on the tensor cores, expected {want_tc}")
        for name, t in (("plain", got_plain), ("fused", got_fused)):
            if t.shape != (b, 5) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"estimator {name} {DT_NAME[dt]}: "
                                     f"shape {tuple(t.shape)} or non-finite")
        logits[dt] = got_plain
        ref = logits[torch.float32]
        rec = {"phase": "estimator", "dtype": DT_NAME[dt], "batch": b,
               "size": size, "k4_launches_per_forward": 29,
               "k4_tensor_core_launches_per_forward": want_tc,
               "k4_3xtf32_launches_per_forward": want_f32,
               "max_abs_logit": float(ref.abs().max()),
               "fused_vs_plain_rel": rel(got_fused, got_plain)}
        # the plain module as a caller without a graph runs it (under
        # inference_mode) and with autograd on (what load_estimator's apply
        # does alone: nothing requires a gradient, so no graph is kept),
        # interleaved to show the spread between readings
        runs = {"inference_mode": [], "autograd_on": []}
        for mode in ("inference_mode", "autograd_on", "autograd_on",
                     "inference_mode"):
            with torch.inference_mode(mode == "inference_mode"):
                runs[mode].append(ips_of(lambda: plain(x), b))
        rec["img_per_s_plain"] = float(np.mean(runs["inference_mode"]))
        rec["img_per_s_plain_autograd_on"] = float(np.mean(
            runs["autograd_on"]))
        rec["img_per_s_plain_readings"] = runs
        before = counters["bottleneck"].launches
        rec["img_per_s_fused"] = ips_of(lambda: fused(x_nchw), b)
        launch_totals["bottleneck"] += (counters["bottleneck"].launches
                                        - before)
        if dt == torch.float32:
            rec["tol"] = LOGIT_TOL
            ok = rec["fused_vs_plain_rel"] <= LOGIT_TOL
        else:
            rec["plain_vs_float32_rel"] = rel(got_plain, ref)
            rec["fused_vs_float32_rel"] = rel(got_fused, ref)
            rec["tol"] = LOGIT_TOL_BF16
            ok = (max(rec["plain_vs_float32_rel"],
                      rec["fused_vs_float32_rel"]) <= LOGIT_TOL_BF16
                  and rec["fused_vs_float32_rel"]
                  <= 2 * rec["plain_vs_float32_rel"])
        emit(rec)
        if not ok:
            raise AssertionError(f"estimator {DT_NAME[dt]}: logits differ "
                                 f"beyond the tolerance: {rec}")

    # the plain module on the card against the same module on the CPU
    xs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    on_cpu = load_estimator(path, device="cpu")(xs)
    on_card = plain_by_dt[torch.float32](xs).cpu()
    r = rel(on_card, on_cpu)
    emit({"phase": "estimator_card_vs_cpu", "shape": [2, 64, 64, 3],
          "rel_err": r, "tol": LOGIT_TOL})
    if not r <= LOGIT_TOL:
        raise AssertionError(f"estimator card vs CPU rel err {r}")

    # K1, K2 and K4 in one path: translate to every class, re-classify
    batches = [rng.uniform(-1, 1, (8, size, size, 3)).astype(np.float32)
               for _ in range(2)]
    seen = {"fused": [], "plain": []}

    def classifier(name, fn):
        def classify(images):
            out = fn(images)
            seen[name].append(out.float().cpu())
            return out
        return classify

    fused = fused_by_dt[torch.float32]
    y_true, y_fused = counted(
        lambda: class_transfer_consistency(
            transfer, classifier("fused", lambda im: fused(
                im.permute(0, 3, 1, 2))), batches),
        {"adain": 6, "upsample": 6, "bottleneck": 58})
    _, y_plain = class_transfer_consistency(
        transfer, classifier("plain", plain_by_dt[torch.float32]), batches)
    lp = torch.cat(seen["plain"])
    top2 = lp.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    tol = 2 * LOGIT_TOL * max(1.0, float(lp.abs().max()))
    differ = y_fused != y_plain
    emit({"phase": "class_transfer_consistency", "labels": int(y_true.size),
          "agree_with_request": float((y_fused == y_true).mean()),
          "fused_differs_from_plain": int(differ.sum()),
          "logits_rel_err": rel(torch.cat(seen["fused"]), lp),
          "classes_predicted": sorted(set(y_fused.tolist()))})
    want_true = np.repeat(np.arange(5), 8).tolist() * 2
    if (y_fused.shape != (80,) or y_true.tolist() != want_true
            or y_fused.min() < 0 or y_fused.max() > 4):
        raise AssertionError("class_transfer_consistency: wrong labels")
    if (differ & (margin >= tol)).any():
        raise AssertionError("fused and plain classifiers disagree beyond "
                             "the logit tolerance")


GAN_PARITY_MOVE = 5e-5   # bulk bar of an updated parameter (half an update)
# float32 parity bar of two steps that differ in the generator's kernels
# (K1/K2 sum in another order than the plain chain): losses relative to each
# loss, Adam moments relative to the network's largest element
GAN_TOL = 1e-4
BF16_ULP = 2.0 ** -7      # floor of a bfloat16 comparison: two roundings


def counted_run(fn, counters, launch_totals, want=None, what=""):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after; the launches join the main-path totals.  With ``want``
    (kernel -> launches) any other count raises."""
    for m in counters.values():
        m.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: m.launches for k, m in counters.items()}
    for k in counters:
        launch_totals[k] += got[k]
    if want is not None and got != {k: want.get(k, 0) for k in counters}:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return out, got


def gan_snapshot(state, metrics):
    """What a parity check compares after one step, on the CPU: the losses;
    per network the updated parameters and Adam's two moments, flattened in
    parameter order (with beta1 = 0 the first moment after one step is the
    gradient itself, plus lr/20 of the parameter: the coupled L2); and the
    u vectors."""
    snap = {"losses": {k: float(v) for k, v in metrics.items()}}
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        named = [(k, p) for k, p in ts.module.named_parameters()
                 if p in ts.optimizer.state]

        def flat(ts_):
            return torch.cat([t.detach().float().flatten()
                              for t in ts_]).cpu()

        snap[net] = {"names": [k for k, _ in named],
                     "params": flat(p for _, p in named),
                     "exp_avg": flat(ts.optimizer.state[p]["exp_avg"]
                                     for _, p in named),
                     "exp_avg_sq_root": flat(
                         ts.optimizer.state[p]["exp_avg_sq"]
                         for _, p in named).sqrt()}
    snap["u"] = {k: v.float().cpu()
                 for k, v in state.disc.module.state_dict().items()
                 if k.endswith("weight_u")}
    return snap


def snapshot_errs(a, b):
    """a against b: each loss's relative error, each network's moments' max
    abs error over the network's largest element and their relative L2
    error, the parameters' Adam sign-flip statistics, and u's max abs
    error."""
    rec = {"loss_rel_err": {
        k: abs(a["losses"][k] - v) / max(abs(v), 1e-30)
        for k, v in b["losses"].items()}}
    for net in ("gen", "disc"):
        if a[net]["names"] != b[net]["names"]:
            raise AssertionError(f"{net}: parameters updated differ")
        for key in ("exp_avg", "exp_avg_sq_root"):
            ref = b[net][key]
            rec[f"{net}_{key}_rel_err"] = float(
                (a[net][key] - ref).abs().max()) / float(ref.abs().max())
            rec[f"{net}_{key}_rel_l2"] = float(
                (a[net][key] - ref).norm() / ref.norm())
        diff = (a[net]["params"] - b[net]["params"]).abs()
        rec[f"{net}_loose_share"] = float((diff > GAN_PARITY_MOVE).float()
                                          .mean())
        rec[f"{net}_max_move_diff"] = float(diff.max())
    rec["u_max_abs_err"] = max(float((v - b["u"][k]).abs().max())
                               for k, v in a["u"].items())
    return rec


MOMENT_KEYS = [f"{net}_{key}_rel_err" for net in ("gen", "disc")
               for key in ("exp_avg", "exp_avg_sq_root")]
L2_KEYS = [k.replace("_rel_err", "_rel_l2") for k in MOMENT_KEYS]
# an input perturbation of one or two float32 roundings: the float32 floor
# of a GAN step's agreement (float32_floor)
ONE_ROUNDING = 2.0 ** -23


def float32_floor(run, x, against):
    """How far the plain float32 step moves when its images move by one or
    two roundings (x * (1 +- 2^-23)): per moment key the larger of the two
    errors against the unperturbed step ``against``.  Any two float32
    computations of the step that round differently split by about this
    much: the cUNet's gradient sums cancel (the biases before each AdaIN's
    mean subtraction), so G's moments move by ~1e-3 of the largest at full
    width.  ``run(images) -> snapshot``."""
    errs = [snapshot_errs(run(x * (1 + sign * ONE_ROUNDING)), against)
            for sign in (1, -1)]
    return {k: max(e[k] for e in errs) for k in MOMENT_KEYS}


def gan_states_agree(a, b, lr, tol, what, floor, extra=0.0):
    """Two float32 GAN steps from one state: losses within rel ``tol`` (plus
    ``extra``); Adam's moments (the gradient and the square root of its
    square) within ``tol`` of the network's largest element plus twice the
    step's float32 ``floor`` (plus ``extra``); updated parameters within
    the Adam sign-flip bound (fewer than 0.5% of the elements beyond 5e-5,
    none beyond 2.2 * lr: with beta1 = 0 an update is about lr * sign(g),
    so an element whose gradient lies below the float noise may step either
    way, and only the moments see a gradient of the wrong size); u within
    1e-4.  Returns the record."""
    rec = snapshot_errs(a, b)
    fails = [f"{k} rel err {v}" for k, v in rec["loss_rel_err"].items()
             if not v <= tol + extra]
    fails += [f"{k} {rec[k]} (floor {floor[k]})" for k in MOMENT_KEYS
              if not rec[k] <= tol + 2 * floor[k] + extra]
    for net in ("gen", "disc"):
        if not (rec[f"{net}_loose_share"] < 5e-3
                and rec[f"{net}_max_move_diff"] <= 2.2 * lr + 1e-6):
            fails.append(f"{net} parameters: {rec[f'{net}_loose_share']} "
                         f"loose, max {rec[f'{net}_max_move_diff']}")
    if not rec["u_max_abs_err"] <= 1e-4:
        fails.append(f"u max abs err {rec['u_max_abs_err']}")
    rec.update(tol=tol, extra=extra, float32_floor=floor)
    rec["worst_moment_share_of_bar"] = max(
        rec[k] / (tol + 2 * floor[k] + extra) for k in MOMENT_KEYS)
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    return rec


def bf16_states_agree(cand, ref, base, base_ref, what, extra=0.0):
    """A bfloat16 step ``cand`` held to ``ref`` no worse than the bfloat16
    step ``base`` is to its float32 counterpart ``base_ref``: every loss
    within twice base's error plus two bfloat16 roundings of the loss (plus
    ``extra``), every moment's relative L2 error within twice base's plus
    two roundings (plus ``extra``; bfloat16 moves G's most cancelling
    gradient sums by their own size, so the largest element's error is
    noise, the L2 over millions is not), u within twice base's error
    plus 1e-4 (the third u update reads D's updated weights, and bfloat16
    gradients flip the sign of some of Adam's steps).  Returns the record
    of cand against ref, with base's errors beside it."""
    rec, rb = snapshot_errs(cand, ref), snapshot_errs(base, base_ref)
    fails = [f"{k} rel err {v} (bf16 plain {rb['loss_rel_err'][k]})"
             for k, v in rec["loss_rel_err"].items()
             if not v <= 2 * rb["loss_rel_err"][k] + BF16_ULP + extra]
    fails += [f"{k} {rec[k]} (bf16 plain {rb[k]})" for k in L2_KEYS
              if not rec[k] <= 2 * rb[k] + BF16_ULP + extra]
    if not rec["u_max_abs_err"] <= 2 * rb["u_max_abs_err"] + 1e-4:
        fails.append(f"u max abs err {rec['u_max_abs_err']} (bf16 plain "
                     f"{rb['u_max_abs_err']})")
    rec["extra"] = extra
    rec["bf16_plain_vs_float32"] = {k: rb[k] for k in
                                    ["loss_rel_err", *L2_KEYS,
                                     "u_max_abs_err"]}
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    return rec


def route_sensitivity(plain, routed, images, rand, eps):
    """How far the K4 route can move a float32 step: ``loss_con`` divides
    each sample's reconstruction error by the distance between its two
    conditions, mean_c |pred - rand| + eps, so a condition error delta
    moves that sample's weight, and its share of G's gradient, by up to
    (mean_c |d pred| + mean_c |d rand|) / distance.  The largest such ratio
    over the batch, from the two estimators' conditions on these images."""
    with torch.no_grad():
        pred_p, rand_p = plain(images).float(), plain(rand).float()
        pred_k, rand_k = routed(images).float(), routed(rand).float()
    delta = ((pred_k - pred_p).abs().mean(dim=1)
             + (rand_k - rand_p).abs().mean(dim=1))
    dist = (pred_p - rand_p).abs().mean(dim=1) + eps
    return float((delta / dist).max()), float(dist.min())


def u_vectors(disc):
    return {k: v.clone() for k, v in disc.state_dict().items()
            if k.endswith("weight_u") and v.numel() > 1}


def step_profile(fn, top=12):
    """One call of ``fn`` under torch.profiler (CUPTI): the device time (the
    union of its CUDA kernels' intervals; annotation ranges such as
    ``Optimizer.step#Adam.step`` are not kernels), the number of kernels,
    and the ``top`` kernel names by summed duration (ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name = {}
    for e in kernels:
        by_name[e.name[:90]] = (by_name.get(e.name[:90], 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy / 1e3, len(kernels), dict(names)


def estimators(path, dt, route, cache):
    """The GAN step's estimator over NCHW images through the package's
    load_step_estimator with its route forced: ``plain`` is the module
    forward; ``k4`` sends the forwards that run without autograd (the
    stop-gradient conditions) through fused_resnet_eval and the one forward
    whose gradient reaches G through the module.  Kept in ``cache``."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator

    if (dt, route) not in cache:
        cache[dt, route] = load_step_estimator(path, dtype=dt, device="cuda",
                                               route=route)
    return cache[dt, route]


def wall_ms(fn, n=3):
    """Median host-clock ms of ``n`` synchronized calls, after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_gan(est_path, counters, launch_totals, tf32_totals):
    """The GAN combined step (train/gan.py) on the card at full width: the
    7.8 M-parameter cUNet (plain and use_pallas = K1 + K2), the SNDisc, and
    the seeded ResNet-101 through load_estimator (plain, or its no-grad
    forwards through K4); 224x224, batch 8, est mode (GanConfig's
    defaults)."""
    from weather_unet_tpu_torch.core.rng import train_generator
    from weather_unet_tpu_torch.models import ResNet
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_eval_step, make_gan_step)

    cfg = GanConfig()
    b, size = cfg.batch_size, cfg.input_size
    rng = np.random.default_rng(SEED + 6)

    def batch(bb, ss, device="cuda"):
        return torch.from_numpy(rng.uniform(-1, 1, (bb, 3, ss, ss)).astype(
            np.float32)).to(device)

    images, rand = batch(b, size), batch(b, size)
    zeros = torch.zeros(b, dtype=torch.long, device="cuda")

    # 0. the K4-routed estimator against the plain module on one batch of
    #    8 (comparison launches: they join no main-path total)
    est_cache = {}
    logits = {}
    for dt in DTYPES:
        plain = estimators(est_path, dt, "plain", est_cache)
        routed = estimators(est_path, dt, "k4", est_cache)
        with torch.no_grad():
            lp = plain(images)
            n0 = counters["bottleneck"].launches
            lr_ = routed(images)
            torch.cuda.synchronize()
            n_k4 = counters["bottleneck"].launches - n0
        n0 = counters["bottleneck"].launches
        routed(images)              # autograd on: the plain module
        torch.cuda.synchronize()
        n_k4_grad = counters["bottleneck"].launches - n0
        logits[dt] = lp
        ref = logits[torch.float32]
        rec = {"phase": "gan_estimator", "dtype": DT_NAME[dt], "batch": b,
               "k4_launches_no_grad": n_k4, "k4_launches_grad": n_k4_grad,
               "routed_vs_plain_rel": max_err(lr_, lp) / max(
                   1.0, float(lp.float().abs().max()))}
        if dt == torch.float32:
            rec["tol"] = LOGIT_TOL
            ok = rec["routed_vs_plain_rel"] <= LOGIT_TOL
        else:
            scale = max(1.0, float(ref.abs().max()))
            rec["plain_vs_float32_rel"] = max_err(lp, ref) / scale
            rec["routed_vs_float32_rel"] = max_err(lr_, ref) / scale
            rec["tol"] = LOGIT_TOL_BF16
            ok = (max(rec["plain_vs_float32_rel"],
                      rec["routed_vs_float32_rel"]) <= LOGIT_TOL_BF16
                  and rec["routed_vs_float32_rel"]
                  <= 2 * rec["plain_vs_float32_rel"])
        emit(rec)
        if not (ok and n_k4 == 29 and n_k4_grad == 0):
            raise AssertionError(f"gan estimator {DT_NAME[dt]}: {rec}")

    # 1. parity on the card, dropout 0, one combined step from one seed in
    #    each of the eight configurations, compared in pairs below
    def parity_step(dt, use_pallas, route, x=images, count=True):
        cfg0 = GanConfig(dropout_rate=0.0, dtype=dt)
        gen, disc, state = build_gan_state(cfg0, SEED, "cuda",
                                           use_pallas=use_pallas)
        step = make_gan_step(
            gen, disc, estimators(est_path, dt, route, est_cache), cfg0)

        def run():
            return step(state, x, zeros, rand, zeros,
                        train_generator(SEED, "cuda"), do_g=True)

        if count:
            want = {"adain": 6 * use_pallas, "upsample": 6 * use_pallas,
                    "bottleneck": 58 * (route == "k4")}
            what = (f"gan parity {DT_NAME[dt]} use_pallas={use_pallas} "
                    f"est={route}")
            # the K4 route in float32: the 3xTF32 form, two estimator
            # forwards without autograd a step
            n_f32 = 2 * tf32_want(counters, dt, "bottleneck",
                                  GAN_SITES["bottleneck"]) * (route == "k4")
            (state, m), _ = tf32_run(
                lambda: counted_run(run, counters, launch_totals, want, what),
                counters, tf32_totals, {"bottleneck_3xtf32": n_f32}, what)
        else:
            state, m = run()
        return gan_snapshot(state, m)

    snaps = {(dt, use_pallas, route): parity_step(dt, use_pallas, route)
             for dt in DTYPES for use_pallas in (False, True)
             for route in ("plain", "k4")}
    # float32: pairs that differ in one thing -- the generator's kernels
    # under each estimator route at GAN_TOL plus twice the float32 floor,
    # and the route under the plain generator at that bar plus twice
    # route_sensitivity
    f32, bf = torch.float32, torch.bfloat16
    floor = float32_floor(
        lambda x: parity_step(f32, False, "plain", x, count=False), images,
        snaps[f32, False, "plain"])
    sens = {dt: route_sensitivity(
        estimators(est_path, dt, "plain", est_cache),
        estimators(est_path, dt, "k4", est_cache), images, rand,
        cfg.con_eps) for dt in DTYPES}
    pairs = [((f32, True, "plain"), (f32, False, "plain"), GAN_TOL),
             ((f32, True, "k4"), (f32, False, "k4"), GAN_TOL),
             ((f32, False, "k4"), (f32, False, "plain"), GAN_TOL)]
    # bfloat16: the use_pallas generator against the float32 plain one under
    # the same route, no further from it than the bfloat16 plain generator
    # is; the route under the plain generator within that bar plus twice
    # its bfloat16 route_sensitivity (the K4 route itself is held by its
    # logits above)
    pairs += [((bf, True, r), (f32, False, r), (bf, False, r))
              for r in ("plain", "k4")]
    pairs += [((bf, False, "k4"), (bf, False, "plain"), (bf, False, "plain"))]
    for cand, against, tol in pairs:
        what = (f"gan parity {DT_NAME[cand[0]]} use_pallas={cand[1]} "
                f"est={cand[2]} against {DT_NAME[against[0]]} "
                f"use_pallas={against[1]} est={against[2]}")
        if cand[0] == f32:
            extra = 2 * sens[f32][0] if cand[2] != against[2] else 0.0
            rec = gan_states_agree(snaps[cand], snaps[against], cfg.lr, tol,
                                   what, floor, extra)
        else:
            base = tol
            extra = 2 * sens[bf][0] if cand[2] != against[2] else 0.0
            rec = bf16_states_agree(snaps[cand], snaps[against], snaps[base],
                                    snaps[(f32,) + base[1:]], what, extra)
        if cand[2] != against[2]:
            (rec["route_sensitivity"],
             rec["min_condition_distance"]) = sens[cand[0]]
        emit({"phase": "gan_parity", "dtype": DT_NAME[cand[0]],
              "use_pallas": cand[1], "estimator": cand[2],
              "against": {"dtype": DT_NAME[against[0]],
                          "use_pallas": against[1], "estimator": against[2]},
              "batch": b, "size": size, "losses": snaps[cand]["losses"],
              **rec})
    del snaps

    # 2. the same step on the card against the CPU, 32x32, batch 2, a
    #    depth-(1, 1, 1, 1) estimator
    from weather_unet_tpu_torch.cli.common import load_estimator

    small = os.path.join(os.path.dirname(est_path), "estimator_small.pt")
    torch.save(ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                      .manual_seed(SEED + 7)).state_dict(), small)
    cfg_s = GanConfig(input_size=32, batch_size=2, dropout_rate=0.0)
    xs, rs = batch(2, 32, "cpu"), batch(2, 32, "cpu")
    def small_step(dev, x=xs, count=True):
        apply = load_estimator(small, device=dev)
        gen, disc, state = build_gan_state(cfg_s, SEED, dev, use_pallas=True)
        step = make_gan_step(gen, disc,
                             lambda im: apply(im.permute(0, 2, 3, 1)), cfg_s)
        z = torch.zeros(2, dtype=torch.long, device=dev)

        def run():
            return step(state, x.to(dev), z, rs.to(dev), z,
                        train_generator(SEED, dev), do_g=True)

        if count:
            want = {"adain": 6, "upsample": 6} if dev == "cuda" else {}
            (state, m), _ = counted_run(run, counters, launch_totals, want,
                                        f"gan small {dev}")
        else:
            state, m = run()
        return gan_snapshot(state, m)

    snaps = {dev: small_step(dev) for dev in ("cuda", "cpu")}
    floor = float32_floor(lambda x: small_step("cpu", x, count=False), xs,
                          snaps["cpu"])
    rec = gan_states_agree(snaps["cuda"], snaps["cpu"], cfg_s.lr, GAN_TOL,
                           "gan card vs CPU", floor)
    emit({"phase": "gan_card_vs_cpu", "batch": 2, "size": 32, **rec})
    del snaps

    # 3. steady state at dropout 0.3: f32 and bf16 (float32 master weights),
    #    plain and use_pallas generator, plain and K4-routed estimator
    n_warm, n_timed = 2, 5
    records = []
    for dt in DTYPES:
        for use_pallas in (False, True):
            for route in ("plain", "k4"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                cfg_d = GanConfig(dtype=dt)
                est = estimators(est_path, dt, route, est_cache)
                gen, disc, state = build_gan_state(cfg_d, SEED, "cuda",
                                                   use_pallas=use_pallas)
                step = make_gan_step(gen, disc, est, cfg_d)
                gen_rng = train_generator(SEED, "cuda")
                per = {"adain": 6 * use_pallas, "upsample": 6 * use_pallas,
                       "bottleneck": 58 * (route == "k4")}
                u0 = u_vectors(disc)
                what = (f"gan {DT_NAME[dt]} use_pallas={use_pallas} "
                        f"est={route}")

                def run(n, do_g=True):
                    times, metrics = [], []
                    for _ in range(n):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, m = step(state, images, zeros, rand, zeros,
                                    gen_rng, do_g=do_g)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        metrics.append(m)
                    return times, metrics

                counted_run(lambda: run(n_warm), counters, launch_totals,
                            {k: n_warm * v for k, v in per.items()}, what)
                (times, metrics), _ = counted_run(
                    lambda: run(n_timed), counters, launch_totals,
                    {k: n_timed * v for k, v in per.items()}, what)
                step_ms = float(np.median(times)) * 1e3
                (_, d_only), _ = counted_run(
                    lambda: run(1, do_g=False), counters, launch_totals,
                    {k: v // 2 if k != "bottleneck" else v
                     for k, v in per.items()}, what + " D only")
                (device_ms_step, n_kernels, top), _ = counted_run(
                    lambda: step_profile(lambda: run(1)), counters,
                    launch_totals, per, what + " profiled")
                steps = n_warm + n_timed + 2
                finite = all(bool(torch.isfinite(v)) for m in metrics
                             + d_only for v in m.values())
                moved = all(not torch.equal(u, disc.state_dict()[k])
                            for k, u in u0.items())
                if not (finite and moved and state.global_step == steps
                        and state.disc.step == steps
                        and state.gen.step == steps - 1):
                    raise AssertionError(
                        f"{what}: finite {finite}, u moved {moved}, steps "
                        f"{state.global_step}/{state.gen.step}/"
                        f"{state.disc.step}")
                # the estimator's share: its two stop-gradient forwards and
                # the forward + input backward on G's output, timed apart
                fake = gen(images, est(rand).detach(), train=True,
                           generator=gen_rng).detach().requires_grad_()

                def est_work():
                    with torch.no_grad():
                        est(images)
                        est(rand)
                    torch.autograd.grad(est(fake).sum(), fake)

                est_ms, _ = counted_run(lambda: wall_ms(est_work), counters,
                                        launch_totals)
                rec = {"phase": "gan_step", "dtype": DT_NAME[dt],
                       "use_pallas": use_pallas, "estimator": route,
                       "batch": b, "size": size, "dropout": cfg_d.dropout_rate,
                       "step_ms_median": step_ms,
                       "step_ms_all": [t * 1e3 for t in times],
                       "img_per_s": b / step_ms * 1e3,
                       "peak_mem_gib": torch.cuda.max_memory_allocated()
                       / 2 ** 30,
                       "device_ms_one_step": device_ms_step,
                       "device_busy_share": device_ms_step / step_ms,
                       "device_kernels_one_step": n_kernels,
                       "top_kernels_ms": top,
                       "estimator_ms": est_ms,
                       "estimator_share": est_ms / step_ms,
                       "launches_per_step": per,
                       "losses": {k: float(v) for k, v in metrics[-1].items()}}
                emit(rec)
                records.append(rec)
                last = (gen, disc, state, est, cfg_d)
                del step

    # 4. the evaluation step once, batch 8, on the last configuration (bf16,
    #    use_pallas, K4-routed estimator): 8 G forwards, 8 estimator forwards
    gen, disc, state, est, cfg_d = last
    refs = torch.eye(5, device="cuda")[torch.arange(b) % 5]
    labels = torch.eye(5, device="cuda")[(torch.arange(b) + 1) % 5]
    u0 = u_vectors(disc)
    (metrics, fakes), _ = counted_run(
        lambda: make_eval_step(gen, disc, est, cfg_d)(
            state, images, labels, refs, train_generator(SEED, "cuda")),
        counters, launch_totals,
        {"adain": 3 * b, "upsample": 3 * b, "bottleneck": 29 * b},
        "gan eval step")
    ok = (tuple(fakes.shape) == (b, b, 3, size, size)
          and all(bool(torch.isfinite(v)) for v in metrics.values())
          and bool(torch.isfinite(fakes).all())
          and all(torch.equal(u, disc.state_dict()[k])
                  for k, u in u0.items()))
    emit({"phase": "gan_eval", "dtype": DT_NAME[cfg_d.dtype],
          "fakes_shape": list(fakes.shape),
          "metrics": {k: float(v) for k, v in metrics.items()}, "ok": ok})
    if not ok:
        raise AssertionError("gan eval step: wrong shape, non-finite values "
                             "or u moved")
    return records


TRAIN_STEPS = 10          # timed trainer steps per dtype
PROFILED_STEPS = 3        # trainer steps under torch.profiler
N_JPEGS = 96              # synthetic 256x256 JPEGs for the CLI runs


def host_packages():
    """What the host offers the data path: Pillow, pandas, TensorBoard,
    scikit-learn and matplotlib (version, or None), and libjpeg's header
    and library (the native runtime's decode needs them; without them it
    builds augment-only and Pillow decodes)."""
    import ctypes.util
    import importlib

    out = {}
    for mod in ("PIL", "pandas", "tensorboard", "sklearn", "matplotlib"):
        try:
            out[mod.lower()] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod.lower()] = None
    out["jpeglib_h"] = any(os.path.exists(os.path.join(d, "jpeglib.h"))
                           for d in ("/usr/include", "/usr/local/include"))
    out["libjpeg"] = ctypes.util.find_library("jpeg")
    return out


def write_jpegs(root, n, size=256, seed=SEED + 9):
    """``n`` seeded smooth-plus-noise RGB JPEGs of size x size; their
    paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    paths = []
    for i in range(n):
        base = rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
            xx[..., None] / rng.uniform(8, 40)
            + yy[..., None] / rng.uniform(8, 40)))
        img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
        paths.append(os.path.join(root, f"{i:03d}.jpg"))
        Image.fromarray(img.astype(np.uint8)).save(paths[-1], quality=90)
    return paths


def state_equal(a, b):
    """Two GAN states hold bit-equal networks, Adam states and counters."""
    for net in ("gen", "disc"):
        ta, tb = getattr(a, net), getattr(b, net)
        sa, sb = ta.module.state_dict(), tb.module.state_dict()
        oa = ta.optimizer.state_dict()["state"]
        ob = tb.optimizer.state_dict()["state"]
        if (sa.keys() != sb.keys() or oa.keys() != ob.keys()
                or ta.step != tb.step
                or not all(torch.equal(v, sb[k]) for k, v in sa.items())
                or not all(torch.equal(v, ob[i][k]) for i in oa
                           for k, v in oa[i].items())):
            return False
    return (a.epoch, a.global_step) == (b.epoch, b.global_step)


def train_cli(argv, eval_every, windows):
    """``cli/train_transfer_est.py::main(argv)`` in this process with the
    trainer's checkpoint/evaluation cadence at ``eval_every`` steps and its
    summary window at 4; each window's ``perf/images_per_sec`` is appended
    to ``windows``."""
    from weather_unet_tpu_torch.cli.train_transfer_est import main
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer as T

    saved = (T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary)

    def update_summary(self):
        saved[2](self)
        windows.append(self.scalar_dict.get("perf/images_per_sec"))

    T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary = (
        eval_every, 4, update_summary)
    try:
        main(argv)
    finally:
        T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary = saved


# the CLI in a child process, its cadence checkpoint every 3 steps so that
# the parent can send SIGTERM once training is under way
PREEMPT_CHILD = ("import sys\n"
                 "from weather_unet_tpu_torch.train.loops import "
                 "WeatherTransferTrainer\n"
                 "WeatherTransferTrainer.EVAL_PER_STEP = 3\n"
                 "from weather_unet_tpu_torch.cli.train_transfer_est import "
                 "main\n"
                 "main(sys.argv[1:])\n")


def run_child(argv, stop_when, timeout=240):
    """Run the CLI in a child process and send it SIGTERM once the file
    ``stop_when`` exists.  Returns (exit code, output, seconds).  The child
    never outlives the call."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", PREEMPT_CHILD, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while (proc.poll() is None and not os.path.exists(stop_when)
               and time.perf_counter() - t0 < timeout):
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, time.perf_counter() - t0


def phase_train(est_path, counters, launch_totals, gan_records, smi):
    """The trainer loop (train/loops.py) on the card at full width, 224x224,
    batch 8: trainer = hand step (f32, dropout 0), launches per trainer
    step, trainer img/s in bf16 and f32 beside the bare step's, the device
    busy share, a checkpoint round trip and the reference export; then, on
    seeded JPEGs, the est CLI (--image_only, bf16, --augmentation, 4
    workers, 2 epochs; and the frame mode where pandas is present), the
    loader alone, and SIGTERM -> checkpoint -> resume in a child process."""
    from weather_unet_tpu_torch.cli.common import (
        load_step_estimator, load_transfer)
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.data.datasets import ImagePathDataset
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import (
        HostAugment, normalize_batch)
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    t_phase = time.perf_counter()
    host = host_packages()
    emit({"phase": "train_host", **host,
          "note": None if host["pil"] else
          "no Pillow: the JPEG path is held on the CPU by the tests only"})
    f32, bf = torch.float32, torch.bfloat16
    b, size = 8, 224
    rng = np.random.default_rng(SEED + 8)
    # FlickrDataset's tuple layout, no decode and no transform
    mem = [(rng.integers(0, 256, (size, size, 3), np.uint8),
            np.zeros(5, np.float32), str(i))
           for i in range(2 * TRAIN_STEPS * b)]

    def loaders(n):
        """A content and a random loader of ``n`` batches each, over
        disjoint images: an image paired with itself puts its two
        conditions at distance 0, where loss_con divides by eps alone."""
        return (BatchLoader(mem[:n * b], b, shuffle=True, num_workers=4),
                BatchLoader(mem[-n * b:], b, shuffle=True, seed=1,
                            num_workers=4))

    ests = {dt: load_step_estimator(est_path, dtype=dt, device="cuda")
            for dt in (f32, bf)}
    per = {f32: {"adain": 6, "upsample": 6},
           bf: {"adain": 6, "upsample": 6, "bottleneck": 58}}
    rec = {"phase": "train", "card": smi, "batch": b, "size": size}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(dt, name, **kw):
            return WeatherTransferTrainer(
                GanConfig(input_size=size, batch_size=b, dtype=dt, **kw),
                ests[dt],
                save_dir=os.path.join(tmp, "cp"), name=name,
                log_dir=os.path.join(tmp, "runs"), device="cuda")

        # 1. trainer = step: one combined step, f32 (TF32 off), dropout 0
        tr = trainer(f32, "parity", dropout_rate=0.0)
        counted_run(lambda: tr.train_epoch(*loaders(1)), counters,
                    launch_totals, per[f32], "trainer f32 step")
        got = gan_snapshot(tr.state, tr._last_metrics)
        x_u8, r_u8 = (next(iter(ld))[0] for ld in loaders(1))
        images = normalize_batch(torch.from_numpy(x_u8).cuda())
        rand = normalize_batch(torch.from_numpy(r_u8).cuda())
        zeros = torch.zeros(b, dtype=torch.long, device="cuda")

        def hand(x):
            cfg0 = GanConfig(input_size=size, batch_size=b, dropout_rate=0.0)
            gen, disc, state = build_gan_state(cfg0, 0, "cuda",
                                               use_pallas=True)
            g = torch.Generator("cuda").manual_seed(fold_seed(1, 1))
            state, m = make_gan_step(gen, disc, ests[f32], cfg0)(
                state, x, zeros, rand, zeros, g, do_g=True)
            return gan_snapshot(state, m)

        want = hand(images)
        floor = float32_floor(hand, images, want)
        # the card's own run-to-run split of the same step, for reference
        again = snapshot_errs(hand(images), want)
        rec["hand_step_twice"] = {k: again[k] for k in (
            "gen_loose_share", "gen_exp_avg_rel_err", "u_max_abs_err")}
        rec["trainer_vs_step"] = gan_states_agree(
            got, want, GanConfig().lr, GAN_TOL, "trainer vs hand step",
            floor)
        del tr, got, want

        # 2. throughput and launches a step, bf16 (K4 route) and f32
        for dt in (bf, f32):
            tr = trainer(dt, f"speed_{DT_NAME[dt]}")
            counted_run(lambda: tr.train_epoch(*loaders(2)), counters,
                        launch_totals, {k: 2 * v for k, v in per[dt].items()},
                        f"trainer {DT_NAME[dt]} warm-up")
            t0 = time.perf_counter()
            counted_run(lambda: tr.train_epoch(*loaders(TRAIN_STEPS)),
                        counters, launch_totals,
                        {k: TRAIN_STEPS * v for k, v in per[dt].items()},
                        f"trainer {DT_NAME[dt]}")
            step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            # the bare step timed the same way (host clock around the same
            # number of unsynchronized steps) on two batches already
            # normalized on the card: no loader, prefetch or normalize
            bare_step = make_gan_step(tr.gen, tr.disc, ests[dt], tr.cfg)
            x, r = (normalize_batch(torch.from_numpy(np.stack(
                [m[0] for m in part])).cuda()) for part in (mem[:b],
                                                             mem[-b:]))
            z = torch.zeros(b, dtype=torch.long, device="cuda")
            g = torch.Generator("cuda")

            def bare_steps():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_STEPS):
                    g.manual_seed(i)
                    bare_step(tr.state, x, z, r, z, g, do_g=True)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / TRAIN_STEPS * 1e3

            bare_ms, _ = counted_run(
                bare_steps, counters, launch_totals,
                {k: TRAIN_STEPS * v for k, v in per[dt].items()},
                f"bare {DT_NAME[dt]} steps")
            (busy_ms, n_kernels, _), _ = counted_run(
                lambda: step_profile(
                    lambda: tr.train_epoch(*loaders(PROFILED_STEPS))),
                counters, launch_totals,
                {k: PROFILED_STEPS * v for k, v in per[dt].items()},
                f"trainer {DT_NAME[dt]} profiled")
            bare = [r for r in gan_records if r["dtype"] == DT_NAME[dt]
                    and r["use_pallas"] and r["estimator"]
                    == ("k4" if dt == bf else "plain")][0]
            rec[DT_NAME[dt]] = {
                "trainer_step_ms": step_ms,
                "trainer_img_per_s": b / step_ms * 1e3,
                "bare_step_same_window_ms": bare_ms,
                "bare_step_same_window_img_per_s": b / bare_ms * 1e3,
                "phase_gan_bare_step_img_per_s": bare["img_per_s"],
                "device_ms_per_step": busy_ms / PROFILED_STEPS,
                "device_busy_share": busy_ms / PROFILED_STEPS / step_ms,
                "kernels_per_step": n_kernels / PROFILED_STEPS,
                "launches_per_step": per[dt]}
            if dt == bf:
                last = tr
            else:
                del tr
        # a D-only step between two combined ones (GD_train_ratio 2)
        tr2 = trainer(bf, "d_only", gd_train_ratio=2)
        d_only = {"adain": 3, "upsample": 3, "bottleneck": 58}
        counted_run(lambda: tr2.train_epoch(*loaders(2)), counters,
                    launch_totals,
                    {k: v + d_only[k] for k, v in per[bf].items()},
                    "trainer bf16 D-only + combined")
        del tr2
        # the device augment: both batches warped on the card (resized
        # crop and jitter) in place of normalize_batch; the launches a
        # step do not change
        tr3 = WeatherTransferTrainer(
            GanConfig(input_size=size, batch_size=b, dtype=bf), ests[bf],
            save_dir=os.path.join(tmp, "cp"), name="device_augment",
            log_dir=os.path.join(tmp, "runs"), device="cuda",
            device_augment=True, augment=True)
        counted_run(lambda: tr3.train_epoch(*loaders(1)), counters,
                    launch_totals, per[bf], "trainer bf16 device_augment")
        losses = {k: float(v) for k, v in tr3._last_metrics.items()}
        rec["device_augment_step"] = {"losses": losses,
                                      "launches_per_step": per[bf]}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"device_augment step: {losses}")
        del tr3

        # 3. checkpoint: async save of the bf16 trainer, round trip, export
        tree = ckpt.gan_tree(last.state, last.seed)
        torch.cuda.synchronize()
        saver = ckpt.AsyncCheckpointer()
        t0 = time.perf_counter()
        saver.save(tmp, "round_trip", last.state.global_step, tree)
        t1 = time.perf_counter()
        path = saver.wait()
        t2 = time.perf_counter()
        saver.close()
        _, _, fresh = build_gan_state(
            GanConfig(input_size=size, batch_size=b, dtype=bf), SEED + 1,
            "cuda", use_pallas=True)
        ckpt.restore_checkpoint(path, fresh)
        export = os.path.join(tmp, "export.pt")
        ckpt.export_torch_gan(export, last.gen, last.disc, last.state.epoch,
                              last.state.global_step)
        loaded = load_transfer(export, device="cuda").state_dict()
        exported = all(torch.equal(v, loaded[k])
                       for k, v in last.gen.state_dict().items())
        rec["checkpoint"] = {
            "blocking_ms": (t1 - t0) * 1e3, "total_ms": (t2 - t0) * 1e3,
            "file_mib": os.path.getsize(path) / 2 ** 20,
            "restored_bit_equal": state_equal(fresh, last.state),
            "export_loads_strict": exported}
        if not (rec["checkpoint"]["restored_bit_equal"] and exported):
            raise AssertionError(f"checkpoint round trip: {rec['checkpoint']}")
        del last, fresh, tree, loaded

        if not host["pil"]:
            # no JPEG decode here: fit() over the in-memory loaders
            tr = trainer(bf, "fit", num_epoch=2)
            counted_run(lambda: tr.fit(lambda: loaders(2)[0],
                                       lambda: loaders(2)[1]),
                        counters, launch_totals,
                        {k: 4 * v for k, v in per[bf].items()}, "fit")
            rec["seconds"] = time.perf_counter() - t_phase
            emit(rec)
            return

        # 4. the est CLI on seeded JPEGs: --image_only (70% of them train:
        #    67 images, 8 steps an epoch), 2 epochs, bf16, --augmentation,
        #    4 workers
        spe = int(N_JPEGS * 0.7) // b
        jpegs = os.path.join(tmp, "jpegs")
        os.makedirs(jpegs)
        paths = write_jpegs(jpegs, N_JPEGS)
        common = ["--estimator_path", est_path, "--image_root", jpegs,
                  "--device", "cuda",
                  "--dtype", "bf16", "--augmentation", "--num_workers", "4",
                  "--batch_size", str(b), "--input_size", str(size),
                  "--log_dir", os.path.join(tmp, "runs")]
        cli_dir = os.path.join(tmp, "cli")
        windows = []
        t0 = time.perf_counter()
        counted_run(lambda: train_cli(
            ["--image_only", "--num_epoch", "2", "--export_torch",
             "--save_dir", cli_dir, "--name", "image_only"] + common, 8,
            windows), counters, launch_totals,
            {k: 2 * spe * v for k, v in per[bf].items()},
            "est CLI image_only")
        cli_s = time.perf_counter() - t0
        final = torch.load(ckpt.latest_checkpoint(cli_dir, "image_only"),
                           weights_only=True)["global_step"]
        rec["cli_image_only"] = {
            "seconds": cli_s, "steps": final,
            "window_img_per_s": windows,
            "files": sorted(os.listdir(os.path.join(cli_dir, "image_only")))}
        if final != 2 * spe:
            raise AssertionError(f"est CLI image_only ended at step {final}")

        # the frame mode: 2/3 train rows (64: 8 steps), the rest test rows
        #    (the two cached test batches), one epoch, evaluation every 4
        #    steps
        if host["pandas"]:
            import pandas as pd

            frame = os.path.join(tmp, "frame.pkl")
            n_train = N_JPEGS * 2 // 3
            sig = rng.standard_normal((N_JPEGS, 5)) * 3 + 10
            pd.DataFrame({
                "photo": [f"{i:03d}" for i in range(N_JPEGS)],
                "mode": ["train"] * n_train + ["test"] * (N_JPEGS - n_train),
                **{c: sig[:, j] for j, c in enumerate(
                    ["clouds", "temp", "humidity", "pressure",
                     "windspeed"])},
                "condition2": ["Clear"] * N_JPEGS}).to_pickle(frame)
            evals = {"adain": 3 * b, "upsample": 3 * b,
                     "bottleneck": 29 * b}
            windows = []
            counted_run(lambda: train_cli(
                ["--pkl_path", frame, "--num_epoch", "1", "--save_dir",
                 cli_dir, "--name", "frame"] + common, 4, windows),
                counters, launch_totals,
                {k: n_train // b * v + n_train // b // 4 * evals[k]
                 for k, v in per[bf].items()},
                "est CLI frame mode")
            rec["cli_frame"] = {"window_img_per_s": windows, "files": sorted(
                os.listdir(os.path.join(cli_dir, "frame")))}

        # 5. the loader alone: HostAugment at 4 workers, two epochs
        aug = HostAugment(size, resized_crop=True, brightness=0.5,
                          contrast=0.3, saturation=0.3)
        ds = ImagePathDataset(paths[:int(N_JPEGS * 0.7)],
                              out_size=int(size * 1.15),
                              transform=aug)
        t0 = time.perf_counter()
        n = 0
        for epoch in range(2):
            ld = BatchLoader(ds, b, shuffle=True, num_workers=4)
            ld.set_epoch(epoch)
            n += sum(len(batch[0]) for batch in ld)
        loader_ips = n / (time.perf_counter() - t0)
        # a step takes two batches, one from each loader
        rec["loader"] = {
            "img_per_s": loader_ips, "workers": 4,
            "keeps_up_with_bf16_trainer":
                loader_ips >= 2 * rec["bfloat16"]["trainer_img_per_s"]}

        # 6. SIGTERM -> checkpoint -> resume: the CLI in a child process,
        #    stopped once its step-3 checkpoint lands, then relaunched here
        pre_dir = os.path.join(tmp, "preempt")
        argv = ["--image_only", "--num_epoch", "2", "--save_dir", pre_dir,
                "--name", "p"] + common
        rc1, out1, s1 = run_child(argv, stop_when=os.path.join(
            pre_dir, "p", f"ckpt_s{3:010d}.pt"))
        stop = re.search(r"checkpointing at step (\d+)", out1)
        stop_step = int(stop.group(1)) if stop else 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: train_cli(argv, 3, []), counters,
                        launch_totals,
                        {k: (2 * spe - stop_step) * v
                         for k, v in per[bf].items()}, "est CLI resumed")
        out2 = buf.getvalue()
        final = torch.load(ckpt.latest_checkpoint(pre_dir, "p"),
                           weights_only=True)["global_step"]
        rec["preemption"] = {
            "stop_step": stop_step, "final_step": final,
            "child_exit": rc1, "child_s": s1,
            "resumed_s": time.perf_counter() - t0}
        # a stop on an epoch's last step resumes with nothing to skip
        ok = (rc1 == 0 and "preemption: signal 15" in out1
              and 0 < stop_step < 2 * spe
              and os.path.exists(ckpt.checkpoint_path(pre_dir, "p",
                                                      stop_step))
              and "resumed from" in out2
              and ("resume: fast-forwarding" in out2 or stop_step % spe == 0)
              and final == 2 * spe)
        if not ok:
            print(out1[-4000:], out2[-4000:], file=sys.stderr)
            raise AssertionError(f"preemption: {rec['preemption']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


SUP_BATCH = 64            # the supervised CLIs' default batch
SUP_SIZE = 224            # and input size
SUP_WARMUP, SUP_TIMED = 2, 5
AUG_TOL = 1 / 255 + 1e-3  # native (uint8) vs device augment
# the supervised CLI in a child process; the step wrapper touches the file
# argv[1] after the third step, so that the parent sends SIGTERM while the
# run is under way
PREEMPT_SUP_CHILD = (
    "import sys\n"
    "import weather_unet_tpu_torch.train.supervised as s\n"
    "make, mark = s.make_estimator_step, sys.argv[1]\n"
    "def marked():\n"
    "    step, n = make(), [0]\n"
    "    def run(*a):\n"
    "        out = step(*a)\n"
    "        n[0] += 1\n"
    "        if n[0] == 3:\n"
    "            open(mark, 'w').close()\n"
    "        return out\n"
    "    return run\n"
    "s.make_estimator_step = marked\n"
    "from weather_unet_tpu_torch.cli.train_estimator import main\n"
    "main(sys.argv[2:])\n")


class Labeled:
    """A dataset's images with other targets: ``(ds[i][0], targets[i])``."""

    def __init__(self, ds, targets):
        self.ds, self.targets = ds, targets

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i):
        return self.ds[i][0], self.targets[i]


def loader_ips(ds, epochs=(0,), b=32):
    """img/s of a 4-thread BatchLoader over ``ds`` for the given epochs."""
    from weather_unet_tpu_torch.data.pipeline import BatchLoader

    t0 = time.perf_counter()
    n = 0
    for epoch in epochs:
        ld = BatchLoader(ds, b, shuffle=True, num_workers=4)
        ld.set_epoch(epoch)
        n += sum(len(batch[0]) for batch in ld)
    return n / (time.perf_counter() - t0)


def sup_run(state, kind, loader, counters, launch_totals, what,
            augment_cfg=None, test=()):
    """``train_supervised`` over ``loader`` (SUP_WARMUP + SUP_TIMED
    batches), one epoch, no kernel launched; the step synchronizes and
    stamps the host clock after each update.  Returns the median ms of the
    timed steps (the loop's time a step: loader wait, normalize or warp,
    step), the peak memory and the last metrics."""
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    make = (sup.make_classifier_step if kind == "classifier"
            else sup.make_estimator_step)
    step, stamps, last = make(), [], {}

    def timed(*a):
        st, m = step(*a)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        last.update(m)
        return st, m

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(
            io.StringIO()):
        counted_run(lambda: train_supervised(
            timed, sup.make_eval_metrics(kind), lambda: loader,
            lambda: iter(test), state=state, num_epoch=1,
            input_size=SUP_SIZE,
            augment_cfg=augment_cfg, save_dir=tmp, name=what,
            save_per_epoch=1 << 30,
            target_dtype=torch.long if kind == "classifier"
            else torch.float32), counters, launch_totals, {}, what)
    if len(stamps) != SUP_WARMUP + SUP_TIMED:
        raise AssertionError(f"{what}: {len(stamps)} steps")
    ms = float(np.median(np.diff(stamps[SUP_WARMUP - 1:]))) * 1e3
    metrics = {k: float(v) for k, v in last.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: metrics {metrics}")
    return {"step_ms": ms, "img_per_s": SUP_BATCH / ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "metrics": metrics}


def sup_params_agree(a, b, lr):
    """Parameters of two supervised states after one step from the same
    weights, over the whole network: the Adam sign-flip bound (fewer than
    0.5% beyond 5e-5, none beyond 2.2 * lr)."""
    pa = torch.cat([p.detach().float().cpu().ravel()
                    for p in a.module.parameters()])
    pb = torch.cat([p.detach().float().cpu().ravel()
                    for p in b.module.parameters()])
    d = (pa - pb).abs()
    return {"loose_share": float((d > 5e-5).float().mean()),
            "max_move_diff": float(d.max()),
            "ok": bool((d > 5e-5).float().mean() < 5e-3
                       and d.max() <= 2.2 * lr + 1e-6)}


def phase_supervised(counters, launch_totals, smi):
    """The native runtime, the decode cache, the device augment and
    supervised ResNet-101 pretraining on the card: the runtime's build; the
    native augment against the device augment (same affine and factors,
    257x257 -> 224x224) and the device augment on the card against the
    CPU; loader img/s of HostAugment, NativeAugment and the decode cache
    (fill, then all hits) on 96 seeded 256x256 JPEGs; augment_batch ms at
    B=64; train_supervised card vs CPU (depth-(1, 1, 1, 1), 32x32, B=4,
    float32), the frozen backbone, and full-width timing (ResNet-101, 5
    outputs, 224x224, B=64, bf16 and float32) over in-memory batches, the
    native-augment loader and the device warp; the estimator CLI with the
    decode cache, SIGTERM -> resume in a child process; the classifier
    CLI.  The supervised path launches none of K1-K4 (asserted)."""
    import shutil

    from weather_unet_tpu_torch import runtime
    from weather_unet_tpu_torch.data.cache import CachedAugment, DecodedCache
    from weather_unet_tpu_torch.data.datasets import ImagePathDataset
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import (
        AugmentConfig, HostAugment, NativeAugment, _affine_sample,
        _color_jitter, affine_from_uniforms, augment_batch,
        augment_from_uniforms, draw_uniforms, normalize_batch)
    from weather_unet_tpu_torch.models import ResNet, ResNet101
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    t_phase = time.perf_counter()
    f32, bf = torch.float32, torch.bfloat16
    rt = runtime.load()
    if rt is None or not runtime.augment_available():
        raise AssertionError(f"native runtime: {runtime.build_error()}")
    emit({"phase": "supervised_host", "cxx": shutil.which("c++"),
          "jpeglib_h": any(os.path.exists(os.path.join(d, "jpeglib.h"))
                           for d in ("/usr/include", "/usr/local/include")),
          "jpeg_links": runtime.jpeg_found(), "runtime_mode": rt.mode,
          "runtime_build_s": rt.build_seconds, "runtime_so": rt.path.name})
    rec = {"phase": "supervised", "card": smi, "batch": SUP_BATCH,
           "size": SUP_SIZE, "runtime_mode": rt.mode}
    cfg = AugmentConfig(out_size=SUP_SIZE, resized_crop=True,
                        brightness=0.5, contrast=0.3, saturation=0.3)
    base = int(SUP_SIZE * 1.15)                       # 257

    # 1. native vs device augment, and the device augment card vs CPU
    rng = np.random.default_rng(SEED + 10)
    yy, xx = np.mgrid[:base, :base]
    imgs = np.stack([np.clip(rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
        xx[..., None] / rng.uniform(8, 40) + yy[..., None]
        / rng.uniform(8, 40))) + rng.normal(0, 12, (base, base, 3)), 0, 255)
        for _ in range(8)]).astype(np.uint8)
    x = torch.from_numpy(imgs).cuda()
    u, fs = draw_uniforms(torch.Generator("cuda").manual_seed(SEED), 8, cfg)
    mats = affine_from_uniforms(u, base, base, cfg)
    dev = _color_jitter(_affine_sample(x, mats, SUP_SIZE), fs, cfg).cpu()
    nat_err = max(float((torch.from_numpy(rt.augment_u8(
        imgs[i], mats[i].cpu().numpy(), fs[i].cpu().numpy(),
        SUP_SIZE)).float() / 255.0 - dev[i]).abs().max()) for i in range(8))
    card_cpu_err = float((augment_from_uniforms(x, u, fs, cfg).cpu()
                          - augment_from_uniforms(x.cpu(), u.cpu(),
                                                  fs.cpu(), cfg)
                          ).abs().max())
    rec["augment_parity"] = {"native_vs_device_max_abs": nat_err,
                             "tol": AUG_TOL,
                             "card_vs_cpu_max_abs": card_cpu_err}
    if not (nat_err <= AUG_TOL and card_cpu_err <= 1e-5):
        raise AssertionError(f"augment parity: {rec['augment_parity']}")
    # augment_batch a B=64 batch at 257x257 on the card
    xb = torch.from_numpy(np.concatenate([imgs] * 8)).cuda()
    g = torch.Generator("cuda").manual_seed(SEED)
    rec["augment_batch_ms"] = time_ms(lambda: augment_batch(g, xb, cfg))

    with tempfile.TemporaryDirectory() as tmp:
        # 2. the loaders alone: 96 JPEGs, 257x257 decode, 4 threads
        jpegs = os.path.join(tmp, "jpegs")
        os.makedirs(jpegs)
        paths = write_jpegs(jpegs, N_JPEGS)
        aug_kw = dict(resized_crop=True, brightness=0.5, contrast=0.3,
                      saturation=0.3)
        loaders = {}
        loaders["host_augment"] = loader_ips(ImagePathDataset(
            paths, base, transform=HostAugment(SUP_SIZE, **aug_kw)))
        native = NativeAugment(SUP_SIZE, **aug_kw)
        loaders["native_augment"] = loader_ips(ImagePathDataset(
            paths, base, transform=native))
        cache = DecodedCache(os.path.join(tmp, "cache"), base, paths)
        cached = ImagePathDataset(paths, base, transform=CachedAugment(
            cache, NativeAugment(SUP_SIZE, **aug_kw)))
        loaders["cache_epoch1_fill"] = loader_ips(cached, (0,))
        fill = (cache.hits, cache.misses)
        loaders["cache_epoch2_hits"] = loader_ips(cached, (1,))
        hits = (cache.hits - fill[0], cache.misses - fill[1])
        loaders["cache_reads"] = {"epoch1": fill, "epoch2": hits}
        loaders["native_route"] = native.route
        if fill != (0, N_JPEGS) or hits != (N_JPEGS, 0):
            raise AssertionError(f"decode cache: {loaders['cache_reads']}")
        rec["loader_img_per_s"] = loaders

        # 3. train_supervised card vs CPU: depth-(1, 1, 1, 1), 32x32, B=4,
        #    float32 (TF32 off), one step of each kind from one init
        small = ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                       .manual_seed(SEED + 11))
        xs = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
        targets = {"classifier": rng.integers(0, 5, 4),
                   "estimator": rng.standard_normal((4, 5)).astype(
                       np.float32)}
        parity = {}
        for kind in ("classifier", "estimator"):
            out = {}
            for dev_name in ("cuda", "cpu"):
                model = ResNet((1, 1, 1, 1), 5)
                model.load_state_dict(small.state_dict())
                st = sup.build_supervised_state(model.to(dev_name), 1e-4,
                                                1e-5)
                with tempfile.TemporaryDirectory() as d:
                    make = (sup.make_classifier_step
                            if kind == "classifier"
                            else sup.make_estimator_step)
                    seen = {}

                    def step(*a, make=make, seen=seen):
                        st_, m = make()(*a)
                        seen.update({k: float(v) for k, v in m.items()})
                        return st_, m

                    run = lambda: train_supervised(  # noqa: E731
                        step, sup.make_eval_metrics(kind),
                        lambda: [(xs, targets[kind])], lambda: iter(()),
                        state=st, num_epoch=1, input_size=32, save_dir=d,
                        name="p", target_dtype=torch.long
                        if kind == "classifier" else torch.float32)
                    with contextlib.redirect_stdout(io.StringIO()):
                        if dev_name == "cuda":
                            counted_run(run, counters, launch_totals, {},
                                        f"supervised parity {kind}")
                        else:
                            run()
                out[dev_name] = (st, seen)
            (sc, mc), (sp, mp) = out["cuda"], out["cpu"]
            loss_rel = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12)
                           for k in mp if k != "accuracy")
            stats = max(float((a.float().cpu() - b.float()).abs().max())
                        for (n, a), b in zip(
                            sc.module.state_dict().items(),
                            sp.module.state_dict().values())
                        if n.endswith(("running_mean", "running_var")))
            parity[kind] = {"loss_rel_err": loss_rel,
                            "bn_stats_max_abs": stats,
                            **sup_params_agree(sc, sp, 1e-4)}
            if not (loss_rel <= 1e-4 and stats <= 1e-5
                    and parity[kind]["ok"]):
                raise AssertionError(f"supervised card vs CPU: {parity}")
        rec["card_vs_cpu"] = parity

        # 4. full width: ResNet-101, 5 outputs, 224x224, B=64
        mem = [(rng.integers(0, 256, (SUP_SIZE, SUP_SIZE, 3), np.uint8),
                rng.standard_normal(5).astype(np.float32))
               for _ in range(SUP_BATCH)]
        mem257 = [(imgs[i % 8], mem[i][1]) for i in range(SUP_BATCH)]
        order = list(range(SUP_BATCH)) * (SUP_WARMUP + SUP_TIMED)
        jpeg_targets = [mem[i % SUP_BATCH][1] for i in range(N_JPEGS)]
        jpeg_order = [i % N_JPEGS for i in range(
            SUP_BATCH * (SUP_WARMUP + SUP_TIMED))]
        # a full test batch and a partial one (padded and masked)
        test = [(np.stack([m[0] for m in part]), np.stack([m[1] for m in
                                                           part]))
                for part in (mem, mem[:48])]

        def batches(ds, idx):
            return BatchLoader(ds, SUP_BATCH, sampler=idx, num_workers=4)

        timing = {}
        for dt in (bf, f32):
            name = DT_NAME[dt]
            model = ResNet101(5, dtype=dt, param_dtype=f32,
                              generator=torch.Generator().manual_seed(SEED))
            st = sup.build_supervised_state(model.cuda(), 1e-4, 1e-5)
            rec["parameters"] = sum(p.numel() for p in model.parameters())
            res = {}
            res["estimator_memory"] = sup_run(
                st, "estimator", batches(mem, order), counters,
                launch_totals, f"est_mem_{name}", test=test)
            res["estimator_native_loader"] = sup_run(
                st, "estimator", batches(Labeled(ImagePathDataset(
                    paths, base,
                    transform=NativeAugment(SUP_SIZE, **aug_kw)),
                    jpeg_targets), jpeg_order), counters, launch_totals,
                f"est_native_{name}")
            res["estimator_device_warp"] = sup_run(
                st, "estimator", batches(mem257, order), counters,
                launch_totals, f"est_warp_{name}", augment_cfg=cfg)
            labels = [(m[0], i % 5) for i, m in enumerate(mem)]
            res["classifier_memory"] = sup_run(
                st, "classifier", batches(labels, order), counters,
                launch_totals, f"cls_mem_{name}")
            # device time of one bare estimator step on an in-memory batch
            xm = torch.from_numpy(np.stack([m[0] for m in mem])).cuda()
            tm = torch.from_numpy(np.stack([m[1] for m in mem])).cuda()
            bare = sup.make_estimator_step()
            busy, n_kernels, top = step_profile(
                lambda: bare(st, normalize_batch(xm), tm))
            for r in res.values():
                r["device_busy_share"] = busy / r["step_ms"]
            res["bare_step_device_ms"] = busy
            res["bare_step_kernels"] = n_kernels
            res["bare_step_top_kernels"] = top
            timing[name] = res
            if dt == bf:
                # the frozen backbone: 3 steps, conv1-layer3 bit-identical
                frozen_model = copy.deepcopy(model)
                fst = sup.build_supervised_state(frozen_model, 1e-4, 1e-5,
                                                 pre_trained=True)
                names = sup.resnet_pretrained_frozen(frozen_model)
                before = {n: p.detach().clone() for n, p in
                          frozen_model.named_parameters()}
                fstep = sup.make_estimator_step()
                counted_run(lambda: [fstep(fst, normalize_batch(xm), tm)
                                     for _ in range(3)], counters,
                            launch_totals, {}, "frozen backbone")
                after = dict(frozen_model.named_parameters())
                same = all(torch.equal(after[n], before[n]) for n in names)
                moved = all(not torch.equal(after[n], before[n])
                            for n in after if n not in names)
                rec["frozen_backbone"] = {
                    "frozen_tensors": len(names),
                    "bit_identical_after_3_steps": same,
                    "trainable_all_moved": moved}
                if not (same and moved):
                    raise AssertionError(f"frozen: {rec['frozen_backbone']}")
                del frozen_model, fst
            del model, st, xm, tm
            torch.cuda.empty_cache()
        rec["timing"] = timing

        # 5. the estimator CLI: 64 train rows (8 steps of 8), 32 test rows,
        #    --decode_cache --augmentation --dtype bf16, 2 epochs; then a
        #    child stopped by SIGTERM after its third step and relaunched
        import pandas as pd

        frame = os.path.join(tmp, "frame.pkl")
        sig = rng.standard_normal((N_JPEGS, 5)) * 3 + 10
        classes = ["Clear", "Clouds", "Rain", "Mist", "Snow"]
        pd.DataFrame({
            "photo": [f"{i:03d}" for i in range(N_JPEGS)],
            "mode": ["train"] * 64 + ["test"] * (N_JPEGS - 64),
            **{c: sig[:, j] for j, c in enumerate(
                ["clouds", "temp", "humidity", "pressure", "windspeed"])},
            "w_condition": [classes[i % 5] for i in range(N_JPEGS)],
            "condition2": [classes[i % 5] for i in range(N_JPEGS)]}
        ).to_pickle(frame)
        common = ["--image_root", jpegs, "--pkl_path", frame, "--device",
                  "cuda", "--decode_cache", os.path.join(tmp, "cli_cache"),
                  "--augmentation", "--dtype", "bf16", "-bs", "8",
                  "--num_epoch", "2", "--num_workers", "4", "--log_dir",
                  os.path.join(tmp, "runs")]
        from weather_unet_tpu_torch.cli.train_estimator import main as est
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: est(common + ["--save_path", os.path.join(
                tmp, "cp"), "--name", "est"]), counters, launch_totals, {},
                "estimator CLI")
        cli_s = time.perf_counter() - t0
        final = torch.load(ckpt.latest_checkpoint(os.path.join(tmp, "cp"),
                                                  "est"),
                           weights_only=True)["global_step"]
        route = re.search(r"train augment: (.*)", buf.getvalue())
        rec["estimator_cli"] = {"seconds": cli_s, "final_step": final,
                                "augment": route.group(1) if route
                                else None}
        if final != 16 or "Done: training" not in buf.getvalue():
            raise AssertionError(f"estimator CLI: {rec['estimator_cli']}")

        pre = os.path.join(tmp, "pre")
        argv = common + ["--save_path", pre, "--name", "p"]
        mark = os.path.join(tmp, "step3")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", PREEMPT_SUP_CHILD, mark, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            while (proc.poll() is None and not os.path.exists(mark)
                   and time.perf_counter() - t0 < 240):
                time.sleep(0.02)
            proc.send_signal(__import__("signal").SIGTERM)
            out1, _ = proc.communicate(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        child_s = time.perf_counter() - t0
        stop = re.search(r"checkpointing at step (\d+)", out1)
        stop_step = int(stop.group(1)) if stop else 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: est(argv), counters, launch_totals, {},
                        "estimator CLI resumed")
        out2 = buf.getvalue()
        final = torch.load(ckpt.latest_checkpoint(pre, "p"),
                           weights_only=True)["global_step"]
        rec["preemption"] = {"stop_step": stop_step, "final_step": final,
                             "child_exit": proc.returncode,
                             "child_s": child_s}
        ok = (proc.returncode == 0 and "preemption: signal 15" in out1
              and 0 < stop_step < 16
              and os.path.exists(ckpt.checkpoint_path(pre, "p", stop_step))
              and "resumed from" in out2
              and ("resume: fast-forwarding" in out2 or stop_step % 8 == 0)
              and final == 16)
        if not ok:
            print(out1[-4000:], out2[-4000:], file=sys.stderr)
            raise AssertionError(f"supervised preemption: "
                                 f"{rec['preemption']}")

        # 6. the classifier CLI over a class-path split: 16 train paths (2
        #    steps of 8), 8 test paths, one epoch
        split = {"train": [], "test": []}
        for i, p in enumerate(paths[:24]):
            d = os.path.join(tmp, "i2w", ["sunny", "cloudy", "rain", "snow",
                                          "foggy"][i % 5])
            os.makedirs(d, exist_ok=True)
            os.symlink(p, os.path.join(d, os.path.basename(p)))
            split["train" if i < 16 else "test"].append(
                os.path.join(d, os.path.basename(p)))
        pd.to_pickle(split, os.path.join(tmp, "split.pkl"))
        from weather_unet_tpu_torch.cli.train_classifier import main as cls
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: cls(
                ["--pkl_path", os.path.join(tmp, "split.pkl"), "--device",
                 "cuda", "--augmentation", "--dtype", "bf16", "-bs", "8",
                 "--num_epoch", "1", "--num_workers", "4", "--save_path",
                 os.path.join(tmp, "cls"), "--name", "cls", "--log_dir",
                 os.path.join(tmp, "runs")]), counters, launch_totals, {},
                "classifier CLI")
        final = torch.load(ckpt.latest_checkpoint(os.path.join(tmp, "cls"),
                                                  "cls"),
                           weights_only=True)["global_step"]
        rec["classifier_cli_final_step"] = final
        if final != 2:
            raise AssertionError(f"classifier CLI ended at step {final}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


SERVE_REQUESTS = 96       # HTTP requests per server run
SERVE_CLIENTS = 8         # client threads
N_CLI_JPEGS = 32          # seeded 256x256 JPEGs of the serving world
CPU_SUBSET = 1            # images of the card-vs-CPU CLI runs (CUTS)


@contextlib.contextmanager
def recorded_saves():
    """Record the uint8 picture of every ``PIL.Image.save`` by path (the
    JPEG encoder is not continuous: a 1-step difference before it can move
    a decoded pixel further)."""
    from PIL import Image

    saved = {}
    save = Image.Image.save

    def record(self, fp, *args, **kw):
        saved[str(fp)] = np.asarray(self, np.int16)
        return save(self, fp, *args, **kw)

    Image.Image.save = record
    try:
        yield saved
    finally:
        Image.Image.save = save


def serving_world(root, size_jpeg=256):
    """32 seeded JPEGs named by photo id, a Flickr frame over them (16
    train, 16 test rows of one station, hourly, the signals and the class
    columns), a 16-photo directory for the demo, an i2w tree of 5 classes x
    6 photos split 2 train / 4 test, and a 1-photo-a-class split for the
    card-vs-CPU runs."""
    import pandas as pd
    import shutil

    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, WEATHER_CLASSES_FLICKR, WEATHER_CLASSES_I2W)

    photos = os.path.join(root, "photos")
    os.makedirs(photos)
    paths = write_jpegs(photos, N_CLI_JPEGS, size=size_jpeg)
    rng = np.random.default_rng(SEED + 20)
    ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    df = pd.DataFrame({
        "photo": ids, "mode": ["train"] * 16 + ["test"] * 16,
        "name": "station", "s_unixtime": 1_600_000_000 + 3600 * np.arange(
            len(ids)),
        **{c: rng.standard_normal(len(ids)) * 3 + 10
           for c in SIGNAL_COLUMNS},
        "condition2": [WEATHER_CLASSES_FLICKR[i % 5]
                       for i in range(len(ids))],
        "w_condition": [WEATHER_CLASSES_FLICKR[i % 5]
                        for i in range(len(ids))]})
    frame = os.path.join(root, "frame.pkl")
    df.to_pickle(frame)
    demo_dir = os.path.join(root, "demo_photos")
    os.makedirs(demo_dir)
    for p in paths[:16]:
        shutil.copy(p, demo_dir)
    split = {"train": [], "test": []}
    for ci, cls in enumerate(WEATHER_CLASSES_I2W):
        d = os.path.join(root, "i2w", cls)
        os.makedirs(d)
        for j in range(6):
            dst = os.path.join(d, f"{j}.jpg")
            shutil.copy(paths[(6 * ci + j) % len(paths)], dst)
            split["train" if j < 2 else "test"].append(dst)
    split_pkl = os.path.join(root, "split.pkl")
    pd.to_pickle(split, split_pkl)
    subset_pkl = os.path.join(root, "split_subset.pkl")
    pd.to_pickle({"train": split["train"],
                  "test": [p for p in split["test"]
                           if p.endswith("2.jpg")][:CPU_SUBSET]}, subset_pkl)
    subset_dir = os.path.join(root, "subset")
    os.makedirs(subset_dir)
    for p in paths[:CPU_SUBSET]:
        shutil.copy(p, subset_dir)
    return {"photos": photos, "paths": paths, "frame": frame,
            "demo": demo_dir, "split": split_pkl, "subset_split": subset_pkl,
            "subset_dir": subset_dir, "ids": ids}


def serving_checkpoints(root, est_path, device):
    """The seeded cUNet as a reference .pt bundle and as the JAX trainer's
    msgpack GAN layout (written by the port's writer), the seeded ResNet-101
    as a state-dict .pt and as the JAX supervised loop's msgpack; each
    loaded through load_transfer / load_estimator from both files, whose
    state dicts must be bit-equal.  The weights go once through the JAX
    layout first, so the unused AdaIN embedding and BatchNorm's
    num_batches_tracked (which flax does not keep) are what the converters
    write on the way back."""
    from weather_unet_tpu_torch.cli.common import (
        load_estimator, load_transfer)
    from weather_unet_tpu_torch.compat import torch_io
    from weather_unet_tpu_torch.models import ConditionalUNet, SNDisc
    from weather_unet_tpu_torch.train import checkpoint as ckpt

    def tensors(sd):
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

    gen = torch.Generator().manual_seed(SEED + 21)
    cunet = torch_io.cunet_state_dict_to_jax(
        ConditionalUNet(5, generator=gen).state_dict())
    disc = torch_io.sndisc_state_dict_to_jax(SNDisc(5, generator=gen)
                                             .state_dict())
    files = {"cunet_pt": os.path.join(root, "gan.pt"),
             "cunet_msgpack": os.path.join(root, "ckpt_s0000000100.msgpack"),
             "est_pt": os.path.join(root, "est.pt"),
             "est_msgpack": os.path.join(root, "est.msgpack")}
    torch.save({"inference": tensors(torch_io.cunet_state_dict_from_jax(
        cunet)), "epoch": 1, "global_step": 100}, files["cunet_pt"])
    ckpt.save_checkpoint_file(files["cunet_msgpack"], {
        "gen": {"params": cunet["params"], "step": 100},
        "disc": {"params": disc["params"], "step": 100},
        "spectral": disc["spectral"], "epoch": 1, "global_step": 100})
    est = torch_io.resnet_state_dict_to_jax(
        torch.load(est_path, map_location="cpu", weights_only=True))
    torch.save(tensors(torch_io.resnet_state_dict_from_jax(est)),
               files["est_pt"])
    ckpt.save_checkpoint_file(files["est_msgpack"], {
        "params": est["params"], "batch_stats": est["batch_stats"],
        "epoch": 1, "global_step": 100, "epoch_step": 0})
    rec = {"phase": "serving_checkpoints"}
    for name, path in files.items():
        rec[f"{name}_mib"] = os.path.getsize(path) / 2 ** 20
        if name.endswith("msgpack"):
            t0 = time.perf_counter()
            ckpt.restore_checkpoint(path)
            rec[f"{name}_read_ms"] = (time.perf_counter() - t0) * 1e3
    for kind, loader in (("cunet", lambda p: load_transfer(
            p, device=device).state_dict()), ("est", lambda p: load_estimator(
                p, device=device).model.state_dict())):
        t0 = time.perf_counter()
        from_msgpack = loader(files[f"{kind}_msgpack"])
        rec[f"{kind}_msgpack_load_ms"] = (time.perf_counter() - t0) * 1e3
        from_pt = loader(files[f"{kind}_pt"])
        rec[f"{kind}_bit_equal"] = (
            from_pt.keys() == from_msgpack.keys()
            and all(torch.equal(v, from_msgpack[k])
                    for k, v in from_pt.items()))
        rec[f"{kind}_tensors"] = len(from_pt)
    emit(rec)
    if not (rec["cunet_bit_equal"] and rec["est_bit_equal"]):
        raise AssertionError(f"msgpack and .pt loads differ: {rec}")
    return files


# the HTTP clients, in a process of their own so that they do not share the
# server's interpreter lock: argv[1] is a JSON file naming the server, the
# request bodies (files), queries and an output directory for the answers
HTTP_CLIENT_CHILD = r"""
import json, os, sys, threading, time, urllib.request
spec = json.load(open(sys.argv[1]))
bodies = [open(p, "rb").read() for p in spec["bodies"]]
n, k = len(bodies), spec["clients"]
status, ctype, lat = [None] * n, [None] * n, [None] * n
errors = {}
def client(t):
    for i in range(t, n, k):
        t0 = time.perf_counter()
        req = urllib.request.Request(spec["base"] + "/translate?"
                                     + spec["queries"][i], data=bodies[i],
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                body = r.read()
                status[i], ctype[i] = r.status, r.headers["Content-Type"]
        except Exception as e:   # reported whole by the parent, which fails
            errors[i] = f"{type(e).__name__}: {e}"
            continue
        lat[i] = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(spec["out"], f"{i}.jpg"), "wb") as f:
            f.write(body)
threads = [threading.Thread(target=client, args=(t,)) for t in range(k)]
t0 = time.perf_counter()
for th in threads:
    th.start()
for th in threads:
    th.join()
json.dump({"status": status, "ctype": ctype, "lat": lat, "errors": errors,
           "wall": time.perf_counter() - t0},
          open(os.path.join(spec["out"], "result.json"), "w"))
"""


def http_traffic(base, paths, queries, out, clients=SERVE_CLIENTS):
    """POST every (file, query) from ``clients`` threads of a child
    process; returns the answers (status, content type, bytes), the
    per-request latency ms and the wall seconds, both on the child's
    clock."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"base": base, "bodies": paths, "queries": queries,
                   "clients": clients, "out": out}, f)
    subprocess.run([sys.executable, "-c", HTTP_CLIENT_CHILD, spec],
                   check=True, timeout=600)
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    if res["errors"]:
        raise AssertionError(f"{len(res['errors'])} of {len(paths)} requests "
                             f"failed: {res['errors']}")
    answers = []
    for i, (code, ctype) in enumerate(zip(res["status"], res["ctype"])):
        with open(os.path.join(out, f"{i}.jpg"), "rb") as f:
            answers.append((code, ctype, f.read()))
    return answers, res["lat"], res["wall"]


def http_refusals(base, body):
    """(code of a bad cond, of a bad route, of /profile)."""
    import urllib.error
    import urllib.request

    codes = []
    for url, data in ((f"{base}/translate?cond=1,2", body),
                      (f"{base}/nope", body),
                      (f"{base}/profile?seconds=0.2", b"")):
        try:
            urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST"), timeout=60).close()
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    return codes


def phase_http(files, world, counters, launch_totals, smi, device, size):
    """The HTTP server (cli/serve.py) on the msgpack checkpoint, in float32
    and bfloat16, under 8 client threads of a child process."""
    import urllib.request

    from PIL import Image

    from weather_unet_tpu_torch.cli import serve

    paths = [world["paths"][i % len(world["paths"])]
             for i in range(SERVE_REQUESTS)]
    bodies = [open(p, "rb").read() for p in paths]
    runs = os.path.join(os.path.dirname(world["frame"]), "http")
    rng = np.random.default_rng(SEED + 22)
    names = ["sunny", "cloudy", "rain", "snow", "foggy"]
    queries, conds = [], []
    for i in range(SERVE_REQUESTS):
        k = int(rng.integers(0, 5))
        if i % 3 == 0:
            queries.append(f"class={names[k]}")
            conds.append(np.eye(5, dtype=np.float32)[k])
        elif i % 3 == 1:
            queries.append(f"class={k}")
            conds.append(np.eye(5, dtype=np.float32)[k])
        else:
            v = rng.standard_normal(5).astype(np.float32)
            queries.append("cond=" + ",".join(repr(float(x)) for x in v))
            conds.append(v)
    for dt_flag in ([], ["--bf16"]):
        trace_dir = os.path.join(os.path.dirname(world["frame"]),
                                 f"traces{len(dt_flag)}")
        args = ["--cp_path", files["cunet_msgpack"], "--host", "127.0.0.1",
                "--port", "0", "--input_size", str(size), "--max_batch", "16",
                "--device", device] + dt_flag
        if dt_flag:
            args += ["--profile_dir", trace_dir]
        for m in counters.values():
            m.launches = 0
        t0 = time.perf_counter()
        server = serve.build_server(serve.build_parser().parse_args(args))
        warm_s = time.perf_counter() - t0
        warm = {k: m.launches for k, m in counters.items()}
        for k in counters:
            launch_totals[k] += warm[k]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        dtype = "bfloat16" if dt_flag else "float32"
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            for m in counters.values():
                m.launches = 0
            answers, lat, wall = http_traffic(
                base, paths, queries, f"{runs}/{dtype}")
            synchronize(device)
            got = {k: m.launches for k, m in counters.items()}
            stats = server.batcher.stats()
            for k in counters:
                launch_totals[k] += got[k]
            codes = http_refusals(base, bodies[0])
            for m in counters.values():
                m.launches = 0
            # the same traffic again under torch.profiler: the device busy
            # share of the serving window
            busy_ms = None
            if device == "cuda":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _, _, wall_prof = http_traffic(
                        base, paths, queries, f"{runs}/{dtype}_profiled")
                    torch.cuda.synchronize()
                busy_ms = union_ms([e for e in prof.events()
                                    if e.device_type == DeviceType.CUDA])
            trace = None
            if dt_flag:   # POST /profile (--profile_dir) during 16 requests
                box = {}

                def take():
                    with urllib.request.urlopen(urllib.request.Request(
                            f"{base}/profile?seconds=1.5", data=b"",
                            method="POST"), timeout=120) as r:
                        box["trace"] = json.loads(r.read())["trace"]

                th = threading.Thread(target=take)
                th.start()
                time.sleep(0.3)
                http_traffic(base, paths[:16], queries[:16],
                             f"{runs}/{dtype}_trace")
                th.join(timeout=120)
                trace = box.get("trace")
            synchronize(device)
            for k, m in counters.items():
                launch_totals[k] += m.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        ok = [a[0] == 200 and a[1] == "image/jpeg" for a in answers]
        outs = [np.asarray(Image.open(io.BytesIO(a[2])), np.int16)
                for a in answers]
        shapes_ok = all(o.shape == (size, size, 3) for o in outs)
        rec = {"phase": "serving_http", "dtype": dtype, "card": smi,
               "device": health["device"], "device_name":
               health["device_name"], "requests": SERVE_REQUESTS,
               "clients": SERVE_CLIENTS, "size": size,
               "warmup_s": warm_s, "warmup_launches": warm,
               "requests_per_s": SERVE_REQUESTS / wall,
               "client_p50_ms": float(np.percentile(lat, 50)),
               "client_p90_ms": float(np.percentile(lat, 90)),
               "batch_ms_p50": stats["batch_ms_p50"],
               "batch_ms_p90": stats["batch_ms_p90"],
               "readback_ms_p50": stats["readback_ms_p50"],
               "mean_batch_size": stats["mean_batch_size"],
               "batches": stats["batches"], "launches": got,
               "refusal_codes": codes}
        if busy_ms is not None:
            rec["device_busy_ms"] = busy_ms
            rec["device_busy_share"] = busy_ms / (wall_prof * 1e3)
            rec["requests_per_s_profiled"] = SERVE_REQUESTS / wall_prof
        # answers against the direct translate_u8 through the same encode
        # and what a request's host work costs alone (one thread): the
        # server's Pillow decode + resize of the body, the answer's encode
        direct = []
        t0 = time.perf_counter()
        x = np.stack([serve._decode_resize(b, size) for b in bodies])
        rec["host_decode_ms"] = (time.perf_counter() - t0) * 1e3 / len(x)
        c = np.stack(conds)
        for i in range(0, len(x), 16):
            direct.append(server.transfer.translate_u8(
                x[i:i + 16], c[i:i + 16]).cpu().numpy())
        direct = np.concatenate(direct)
        mean_steps, encoded = [], []
        t0 = time.perf_counter()
        for d in direct:
            encoded.append(io.BytesIO())
            Image.fromarray(d).save(encoded[-1], "JPEG", quality=95)
        rec["host_encode_ms"] = (time.perf_counter() - t0) * 1e3 / len(direct)
        for o, buf in zip(outs, encoded):
            want = np.asarray(Image.open(buf), np.int16)
            mean_steps.append(float(np.abs(o - want).mean()))
        rec["max_mean_step_vs_direct"] = max(mean_steps)
        if trace is not None:
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            rec["profile_trace_events"] = len(events)
            rec["profile_trace_kernels"] = sum(
                e.get("cat") == "kernel" for e in events)
        emit(rec)
        want_launch = {k: 0 for k in counters}
        want_launch.update(adain=3 * stats["batches"],
                           upsample=3 * stats["batches"])
        want_warm = {k: 0 for k in counters}
        n_warm = len(serve.warmup_buckets(16))
        want_warm.update(adain=3 * n_warm, upsample=3 * n_warm)
        if not (all(ok) and shapes_ok and codes == [400, 404,
                                                    403 if not dt_flag
                                                    else 200]):
            raise AssertionError(f"HTTP {dtype}: answers or codes wrong: "
                                 f"{sum(ok)}/{len(ok)} ok, codes {codes}")
        if device == "cuda" and (got != want_launch or warm != want_warm):
            raise AssertionError(f"HTTP {dtype}: launches {got} / warmup "
                                 f"{warm}, expected {want_launch} / "
                                 f"{want_warm} (3 K1 + 3 K2 a forward)")
        if dtype == "float32" and not rec["max_mean_step_vs_direct"] <= 1.0:
            raise AssertionError(f"HTTP float32 answers differ from "
                                 f"translate_u8: {rec['max_mean_step_vs_direct']}")
        if dt_flag and not (rec.get("profile_trace_events") and (
                device != "cuda" or rec["profile_trace_kernels"])):
            raise AssertionError(f"/profile wrote no trace of the traffic: "
                                 f"{trace}")
        if device == "cuda" and not busy_ms > 0:
            raise AssertionError("the profiled traffic ran no kernel")


def union_ms(kernels) -> float:
    """ms covered by the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def synchronize(device):
    if device == "cuda":
        torch.cuda.synchronize()


def phase_cli(files, world, counters, launch_totals, smi, device, size):
    """The nine inference and eval CLIs in this process, with real argv, on
    the card; each must end without error and write what its JAX
    counterpart writes.  Returns the pictures each saved, by path, for the
    card-vs-CPU check."""
    import importlib

    import pandas as pd

    out = os.path.dirname(world["frame"])
    cp, est = files["cunet_msgpack"], files["est_msgpack"]
    n, n_test, n_i2w_test = N_CLI_JPEGS, 16, 20
    dev = ["--device", device, "--input_size", str(size)]
    # (name, argv, images, forwards, what must exist afterwards)
    runs = [
        ("inf_transfer_c", ["--image_root", world["photos"], "--cp_path", cp,
                            "--image_only", "--output_dir",
                            f"{out}/inf_c"], 5 * n, -(-n // 16),
         lambda: len(os.listdir(f"{out}/inf_c")) == 5 * n),
        ("demo", ["--input_dir", world["demo"], "--cp_path", cp,
                  "--estimator_path", est, "--num_classes", "5",
                  "--batch_size", "8", "--num_frames", "2", "--output_dir",
                  f"{out}/demo"], 2 * 5 * 16, 2 * 2,
         lambda: sorted(os.listdir(f"{out}/demo")) == ["output0.gif",
                                                       "output1.gif"]),
        ("inf_transfer_e", ["--image_root", world["photos"], "--pkl_path",
                            world["frame"], "--cp_path", cp,
                            "--estimator_path", est, "--output_dir",
                            f"{out}/inf_e"], 8 * n_test, n_test // 8,
         lambda: len(os.listdir(f"{out}/inf_e")) == 8 * n_test),
        ("inf_1year_signals", ["--image_root", world["photos"], "--pkl_path",
                               world["frame"], "--photo_id",
                               world["ids"][3], "--cp_path", cp,
                               "--output_dir", f"{out}/year"], n,
         -(-n // 16), lambda: len(os.listdir(f"{out}/year")) == n),
        ("inf_classifier_i2w", ["--image_root", world["photos"], "--pkl_path",
                                world["frame"], "--classifier_path", est,
                                "--output_pkl", f"{out}/labeled.pkl"], n, 0,
         lambda: pd.read_pickle(f"{out}/labeled.pkl")["w_condition"]
         .notna().all()),
        ("eval_class_transfer", ["--pkl_path", world["split"], "--cp_path",
                                 cp, "--classifier_path", est,
                                 "--output_dir", f"{out}/ect"],
         5 * 16, 1, lambda: os.path.exists(f"{out}/ect/cm.pkl")),
        ("eval_estimator_transfer", ["--image_root", world["photos"],
                                     "--pkl_path", world["frame"],
                                     "--cp_path", cp, "--estimator_path",
                                     est], n_test * n_test, n_test,
         lambda: True),
        ("eval_classifier_i2w", ["--pkl_path", world["split"],
                                 "--classifier_path", est,
                                 "--copy_misclassified", "--output_dir",
                                 f"{out}/eci"], n_i2w_test, 0,
         lambda: os.path.exists(f"{out}/eci/cm.pkl")),
        ("eval_estimator", ["--image_root", world["photos"], "--pkl_path",
                            world["frame"], "--estimator_path", est,
                            "--plot", "--output_dir", f"{out}/ee"], n_test,
         0, lambda: os.path.exists(f"{out}/ee/errors.pkl")),
    ]
    with recorded_saves() as saved:
        for name, argv, images, forwards, wrote in runs:
            main_fn = importlib.import_module(
                f"weather_unet_tpu_torch.cli.{name}").main
            for m in counters.values():
                m.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                result = main_fn(argv + dev)
            synchronize(device)
            seconds = time.perf_counter() - t0
            got = {k: m.launches for k, m in counters.items()}
            for k in counters:
                launch_totals[k] += got[k]
            rec = {"phase": "serving_cli", "cli": name, "card": smi,
                   "size": size, "images": images, "seconds": seconds,
                   "img_per_s": images / seconds, "forwards": forwards,
                   "launches": got, "stdout_tail":
                   text.getvalue().strip().splitlines()[-1:]}
            if isinstance(result, dict) and "text" in result:
                rec["accuracy"] = result["report"].get("accuracy")
            elif isinstance(result, dict) and "signed_mean" in result:
                rec["finite"] = bool(np.isfinite(result["signed_mean"]).all())
            emit(rec)
            want = {k: 0 for k in counters}
            want.update(adain=3 * forwards, upsample=3 * forwards)
            if device == "cuda" and got != want:
                raise AssertionError(f"{name}: launches {got} != {want}")
            if not wrote() or rec.get("finite") is False:
                raise AssertionError(f"{name}: outputs missing or wrong")
    return saved


def phase_card_vs_cpu(files, world, card_saved, smi, device, size):
    """inf_transfer_c and eval_class_transfer on the CPU (--device cpu) on a
    CPU_SUBSET-image subset against the card: saved pictures within 1 uint8
    step;
    labels equal where the CPU's top-two logits are more than 1e-3
    apart."""
    import weather_unet_tpu_torch.cli.common as common
    from weather_unet_tpu_torch.cli import eval_class_transfer, inf_transfer_c

    out = os.path.dirname(world["frame"])
    with recorded_saves() as saved, contextlib.redirect_stdout(io.StringIO()):
        inf_transfer_c.main(["--image_root", world["subset_dir"],
                             "--cp_path", files["cunet_msgpack"],
                             "--image_only", "--batch_size",
                             str(CPU_SUBSET),
                             "--input_size", str(size), "--device", "cpu",
                             "--output_dir", f"{out}/inf_c_cpu"])
    worst, n_pics = 0, 0
    for f in sorted(os.listdir(f"{out}/inf_c_cpu")):
        cpu = saved[os.path.join(out, "inf_c_cpu", f)]
        card = card_saved[os.path.join(out, "inf_c", f)]
        worst = max(worst, int(np.abs(cpu - card).max()))
        n_pics += 1

    logits = {}
    load = common.load_estimator

    def recording(path, *a, **kw):
        apply = load(path, *a, **kw)

        def rec(images):
            y = apply(images)
            logits[run].append(y.float().cpu())
            return y
        return rec

    common.load_estimator = recording
    try:
        for run in (device, "cpu_run"):
            logits[run] = []
            with contextlib.redirect_stdout(io.StringIO()):
                eval_class_transfer.main([
                    "--pkl_path", world["subset_split"], "--cp_path",
                    files["cunet_msgpack"], "--classifier_path",
                    files["est_msgpack"], "--batch_size", str(CPU_SUBSET),
                    "--input_size", str(size), "--device",
                    "cpu" if run == "cpu_run" else device,
                    "--output_dir", f"{out}/ect_{run}"])
    finally:
        common.load_estimator = load
    card_l, cpu_l = torch.cat(logits[device]), torch.cat(logits["cpu_run"])
    top2 = cpu_l.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    differ = card_l.argmax(1) != cpu_l.argmax(1)
    rec = {"phase": "serving_card_vs_cpu", "card": smi, "size": size,
           "inf_transfer_c_pictures": n_pics, "max_step": worst,
           "labels": int(len(cpu_l)), "labels_differ": int(differ.sum()),
           "labels_differ_clear": int((differ & clear).sum()),
           "logits_max_abs": float((card_l - cpu_l).abs().max())}
    emit(rec)
    if n_pics != 5 * CPU_SUBSET or worst > 1 or rec["labels_differ_clear"]:
        raise AssertionError(f"card vs CPU CLIs disagree: {rec}")


def phase_serving_cli(est_path, counters, launch_totals, smi,
                      device="cuda", size=224):
    """Phase serving_cli: checkpoints, the HTTP server and the nine CLIs at
    full width (the 7.8 M-parameter cUNet, the seeded 42.5 M-parameter
    ResNet-101), float32 with TF32 off, through K1 and K2."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world = serving_world(tmp)
        files = serving_checkpoints(tmp, est_path, device)
        phase_http(files, world, counters, launch_totals, smi, device, size)
        saved = phase_cli(files, world, counters, launch_totals, smi, device,
                          size)
        phase_card_vs_cpu(files, world, saved, smi, device, size)
    emit({"phase": "serving_cli_done",
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------- eval_export

FID_BATCH = 50            # fid_score's default --batch-size
N_FID_JPEGS = 64          # seeded 256x256 JPEGs in each FID directory
FEATURE_TOL = 1e-4        # card vs CPU pool3 features (float32), rel. L2
# bfloat16 pool3 features against float32, relative L2: the calibrated
# random network amplifies a rounding ~60x (tests/test_torch_inception.py),
# so bfloat16's 2^-9 arrives as O(0.05)
FEATURE_TOL_BF16 = 0.25
ART_SIZE = 256            # export_serving's default --input_size
ART_BATCHES = (1, 16)     # cut to two batches (CUTS)
ART_REQUESTS, ART_CLIENTS = 16, 4


def inception_weights(path, seed, x, **kw):
    """A seeded Inception-v3 (``kw``: head and variant) with BatchNorm
    calibrated on the card on ``x`` (NCHW in [0, 1]), saved as a state-dict
    .pth at ``path``."""
    from weather_unet_tpu_torch.models.inception_fid import (
        InceptionV3FID, calibrate_batchnorm)

    model = InceptionV3FID(generator=torch.Generator().manual_seed(seed),
                           **kw).cuda()
    calibrate_batchnorm(model, x)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return path


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def launches_of(counters):
    return {k: m.launches for k, m in counters.items()}


def reset(counters):
    for m in counters.values():
        m.launches = 0


def phase_fid_is(root, counters, smi):
    """Inception-v3 at full width on seeded random weights: the FID
    features at 299x299 (batch 50, float32 with TF32 off and bfloat16),
    card against CPU; the fid_score CLI over two directories, its
    --save-stats .npz against the other directory; the inception_score CLI
    over one directory.  No K1-K4 launch."""
    from weather_unet_tpu_torch.cli import fid_score, inception_score
    from weather_unet_tpu_torch.cli.common import list_images
    from weather_unet_tpu_torch.compat.torch_io import inception_state_dict
    from weather_unet_tpu_torch.evaluation import fid
    from weather_unet_tpu_torch.models.inception_fid import InceptionV3FID

    dirs = {}
    for i, name in enumerate(("a", "b")):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        write_jpegs(dirs[name], N_FID_JPEGS, seed=SEED + 30 + i)
    batches = {k: list(fid._image_batches(list_images(d), FID_BATCH))
               for k, d in dirs.items()}
    calib = torch.from_numpy(batches["a"][0]).cuda().permute(0, 3, 1, 2)
    w_fid = inception_weights(os.path.join(root, "pt_inception.pth"),
                              SEED + 32, calib.contiguous(),
                              with_logits=True)                 # 1008-way
    w_tv = inception_weights(os.path.join(root, "inception_v3.pth"),
                             SEED + 33, calib.contiguous(), with_logits=True,
                             num_logits=1000, tf_variant=False)
    reset(counters)
    rec = {"phase": "eval_inception", "card": smi, "batch": FID_BATCH,
           "images": 2 * N_FID_JPEGS, "input": "256x256 JPEG -> 299x299"}
    acts, fids = {}, {}
    x_dev = torch.from_numpy(batches["a"][0]).cuda().permute(
        0, 3, 1, 2).contiguous()
    for dt in DTYPES:
        name = DT_NAME[dt]
        fn = fid.make_feature_fn(w_fid, dt, device="cuda")
        fn(batches["a"][0])     # cuDNN picks its algorithms: not timed
        t0 = time.perf_counter()
        acts[dt] = {k: fid.get_activations(iter(b), fn)
                    for k, b in batches.items()}
        rec[f"{name}_features_img_per_s"] = (
            2 * N_FID_JPEGS / (time.perf_counter() - t0))
        stats = [fid.compute_statistics(acts[dt][k]) for k in ("a", "b")]
        # the host's sqrtm (its seconds are the Frechet distance's), in
        # float32 only: each 2048x2048 sqrtm takes 11-23 s of the host, and
        # the bfloat16 features are held to the float32 ones below; scipy
        # warns where 64 images leave the covariances singular
        if dt == torch.float32:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                fids[dt] = fid.frechet_distance(*stats[0], *stats[1])
                rec[f"{name}_sqrtm_s"] = time.perf_counter() - t0
            rec[f"{name}_fid"] = fids[dt]
            rec[f"{name}_sqrtm_warnings"] = sorted({
                f"{w.category.__name__}: {str(w.message)[:60]}"
                for w in caught})
        # the network alone on a batch already on the card
        model = InceptionV3FID(dtype=dt)
        model.load_state_dict(inception_state_dict(
            torch.load(w_fid, weights_only=True), with_logits=False))
        model = model.cuda().eval()
        with torch.inference_mode():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ips = ips_of(lambda: model(x_dev), FID_BATCH)
            rec[f"{name}_img_per_s"] = ips
            rec[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(x_dev)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        rec[f"{name}_device_ms"] = union_ms(kernels)
        rec[f"{name}_kernels"] = len(kernels)
        rec[f"{name}_busy_share"] = union_ms(kernels) / (
            1e3 * FID_BATCH / ips)
        del model
    cpu_fn = fid.make_feature_fn(w_fid, device="cpu")
    cpu = cpu_fn(batches["a"][0][:8])
    card = acts[torch.float32]["a"][:8]
    rec["card_vs_cpu_rel_l2"] = rel_l2(card, cpu)
    rec["bf16_vs_f32_rel_l2"] = rel_l2(acts[torch.bfloat16]["a"],
                                       acts[torch.float32]["a"])
    rec["feature_scale"] = float(np.abs(card).mean())
    rec["launches"] = launches_of(counters)
    emit(rec)
    if not (rec["card_vs_cpu_rel_l2"] <= FEATURE_TOL
            and rec["bf16_vs_f32_rel_l2"] <= FEATURE_TOL_BF16
            and all(np.isfinite(v) for v in fids.values())
            and all(np.isfinite(a[k]).all() and a[k].shape == (
                N_FID_JPEGS, 2048) for a in acts.values() for k in a)):
        raise AssertionError(f"Inception features or FID wrong: {rec}")
    if any(rec["launches"].values()):
        raise AssertionError(f"the Inception path launched K1-K4: {rec}")

    # the CLIs as a user runs them (float32, batch 50, the card): the stats
    # of one directory saved, then the FID of that .npz against the other
    # directory (one sqrtm; the directory-against-directory FID reads the
    # same features and is not run again)
    cli = {"phase": "eval_clis", "card": smi}
    argv = [dirs["a"], dirs["b"], "--weights", w_fid, "--device", "cuda"]
    stats_npz = os.path.join(root, "a.npz")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        t0 = time.perf_counter()
        fid_score.main(argv + ["--save-stats", stats_npz])
        cli["save_stats_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli["fid_npz"] = fid_score.main([stats_npz, dirs["b"], "--weights",
                                         w_fid, "--device", "cuda"])
        cli["fid_npz_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli["is_mean"], cli["is_std"] = inception_score.main([
            "--image_dir", dirs["a"], "--weights", w_tv, "--device", "cuda"])
        cli["is_s"] = time.perf_counter() - t0
    cli["stdout"] = [ln for ln in text.getvalue().splitlines()
                     if ln.startswith(("FID", "IS", "saved", "FID inc",
                                       "torchvision"))]
    cli["fid_npz_img_per_s"] = N_FID_JPEGS / cli["fid_npz_s"]
    saved = np.load(stats_npz)
    mu_a, sigma_a = fid.compute_statistics(acts[torch.float32]["a"])
    # the CLI's own network against the in-process one: relative to each
    # statistic's largest element
    cli["saved_stats_rel_err"] = float(max(
        np.abs(saved[k] - v).max() / max(1.0, np.abs(v).max())
        for k, v in (("mu", mu_a), ("sigma", sigma_a))))
    cli["save_stats_img_per_s"] = N_FID_JPEGS / cli["save_stats_s"]
    cli["is_img_per_s"] = N_FID_JPEGS / cli["is_s"]
    cli["launches"] = launches_of(counters)
    emit(cli)
    close = lambda a, b: abs(a - b) <= 1e-6 * max(1.0, abs(b))  # noqa: E731
    if not (close(cli["fid_npz"], fids[torch.float32])
            and cli["saved_stats_rel_err"] <= 1e-5
            and np.isfinite(cli["is_mean"]) and cli["is_mean"] >= 1.0):
        raise AssertionError(f"FID / IS CLIs disagree: {cli}")
    if any(cli["launches"].values()):
        raise AssertionError(f"the FID / IS CLIs launched K1-K4: {cli}")
    return dirs


def artifact_tensors_on(program) -> set:
    """Device types of an exported program's parameters and buffers (the
    weights and translate_u8's table)."""
    return {t.device.type for t in itertools.chain(program.parameters(),
                                                   program.buffers())}


def phase_export(root, dirs, counters, launch_totals, smi):
    """The use_pallas cUNet at full width exported through export_serving
    --check in float32 (TF32 off) and bfloat16; ExportedTransfer against
    the live WeatherTransfer at batches 1 and 16; K1 and K2 3 times a
    forward of the program (counters and torch.profiler); img/s at batch
    16 against the live forward; then serve --artifact under 4 client
    threads of a child process."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli import export_serving
    from weather_unet_tpu_torch.core.export import ExportedTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    pt = os.path.join(root, "cunet.pt")
    torch.save({"inference": ConditionalUNet(
        5, generator=torch.Generator().manual_seed(SEED + 34)).state_dict(),
        "epoch": 0, "global_step": 0}, pt)
    arts, live, art_dirs = {}, {}, {}
    for dt in DTYPES:
        flag = "bf16" if dt == torch.bfloat16 else "f32"
        art_dirs[dt] = out = os.path.join(root, f"art_{flag}")
        rec = {"phase": "eval_export", "dtype": DT_NAME[dt], "card": smi,
               "size": ART_SIZE}
        reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            export_serving.main(["--cp_path", pt, "--out", out,
                                 "--input_size", str(ART_SIZE), "--dtype",
                                 flag, "--device", "cuda", "--check"])
        rec["export_check_s"] = time.perf_counter() - t0
        rec["cli"] = json.loads(text.getvalue().strip().splitlines()[-1])
        rec["check_launches"] = launches_of(counters)     # 2 forwards, B=2
        for k in counters:
            launch_totals[k] += rec["check_launches"][k]
        rec["artifact_mib"] = sum(
            os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
        ) / 2 ** 20
        t0 = time.perf_counter()
        arts[dt] = ExportedTransfer(out)
        rec["load_ms"] = (time.perf_counter() - t0) * 1e3
        rec["tensors_on"] = sorted(
            artifact_tensors_on(arts[dt]._translate)
            | artifact_tensors_on(arts[dt]._translate_u8))
        live[dt] = WeatherTransfer.load(pt, dtype=dt)
        emit(rec)
        want_check = {k: 0 for k in counters}
        want_check.update(adain=6, upsample=6)
        if not (rec["cli"]["checked"] and rec["tensors_on"] == ["cuda"]
                and rec["check_launches"] == want_check
                and live[dt].model.use_pallas):
            raise AssertionError(f"export {flag}: {rec}")

    rng = np.random.default_rng(SEED + 35)
    parity = {"phase": "eval_export_parity", "card": smi, "size": ART_SIZE}
    for b in ART_BATCHES:
        x = rng.uniform(-1, 1, (b, ART_SIZE, ART_SIZE, 3)).astype(np.float32)
        c = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
        u8 = rng.integers(0, 256, (b, ART_SIZE, ART_SIZE, 3), dtype=np.uint8)
        f32 = live[torch.float32].translate(x, c).float()
        for dt in DTYPES:
            name = DT_NAME[dt]
            reset(counters)
            got = arts[dt].translate(x, c).float()
            got_u8 = arts[dt].translate_u8(u8, c)
            torch.cuda.synchronize()
            n = launches_of(counters)
            for k in counters:
                launch_totals[k] += n[k]
            same = live[dt].translate(x, c).float()
            # the export must not change the function: the program against
            # the live model in its dtype; and a bfloat16 program no
            # further from float32 than the live bfloat16 model is
            key = f"{name}_b{b}"
            parity[f"{key}_mae_vs_live"] = float((got - same).abs().mean())
            parity[f"{key}_mae_vs_live_f32"] = float((got - f32).abs().mean())
            parity[f"{key}_live_mae_vs_live_f32"] = float(
                (same - f32).abs().mean())
            parity[f"{key}_u8_max_step"] = int(
                (got_u8.int() - live[dt].translate_u8(u8, c).int()).abs()
                .max())
            parity[f"{key}_launches"] = n
            want = {k: 0 for k in counters}
            want.update(adain=6, upsample=6)     # translate + translate_u8
            if not (parity[f"{key}_mae_vs_live"] <= 1e-5
                    and parity[f"{key}_mae_vs_live_f32"]
                    <= parity[f"{key}_live_mae_vs_live_f32"] + 1e-5
                    and parity[f"{key}_u8_max_step"] <= 1
                    and n == want):
                raise AssertionError(f"artifact {name} at batch {b}: "
                                     f"{parity}")
    # kernel names of one forward of each program, and img/s at batch 16
    for dt in DTYPES:
        name = DT_NAME[dt]
        x16 = torch.from_numpy(rng.uniform(-1, 1, (16, ART_SIZE, ART_SIZE, 3))
                               .astype(np.float32)).cuda().to(dt)
        c16 = torch.eye(5, device="cuda")[torch.arange(16) % 5].to(dt)
        for _ in range(5):    # a profile can lose a short kernel's record
            names = device_kernels(lambda: arts[dt].translate(x16, c16))[0]
            seen = (sum("adain" in n for n in names),
                    sum("upsample2x" in n for n in names))
            if seen == (3, 3):
                break
        parity[f"{name}_profiled_k1_k2"] = seen
        if seen != (3, 3):
            raise AssertionError(f"artifact {name}: profiler saw K1, K2 "
                                 f"{seen} times, expected 3 each: {names}")
        for b in (4, 16):      # a server's typical group, and a full one
            runs = []
            for what in ("live", "artifact", "artifact", "live"):
                wt = live[dt] if what == "live" else arts[dt]
                runs.append((what, ips_of(
                    lambda: wt.translate(x16[:b], c16[:b]), b)))
            for what in ("live", "artifact"):
                parity[f"{name}_{what}_img_per_s_b{b}"] = [
                    v for w, v in runs if w == what]
    reset(counters)
    emit(parity)
    phase_serve_artifact(art_dirs[torch.float32], arts[torch.float32], pt,
                         dirs, counters, launch_totals, smi)


def phase_serve_artifact(art_dir, art, pt, dirs, counters, launch_totals,
                         smi):
    """serve --artifact (float32) answers 16 POSTs of 256x256 JPEGs from 4
    client threads of a child process; then the same traffic to a server
    of the live model (--cp_path) for comparison."""
    from PIL import Image

    from weather_unet_tpu_torch.cli import serve

    paths = sorted(os.path.join(dirs["a"], f)
                   for f in os.listdir(dirs["a"]))[:ART_REQUESTS]
    ks = [i % 5 for i in range(ART_REQUESTS)]
    queries = [f"class={k}" for k in ks]
    live_rps = {}
    for source in (["--cp_path", pt, "--input_size", str(ART_SIZE)],
                   ["--artifact", art_dir]):
        reset(counters)
        server = serve.build_server(serve.build_parser().parse_args(
            source + ["--host", "127.0.0.1", "--port", "0", "--max_batch",
                      "16", "--device", "cuda"]))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            for run in range(2):
                _, _, wall = http_traffic(
                    base, paths, queries, os.path.join(os.path.dirname(
                        art_dir), f"http_{source[0][2:]}_{run}"),
                    clients=ART_CLIENTS)
                live_rps.setdefault(source[0][2:], []).append(
                    ART_REQUESTS / wall)
            torch.cuda.synchronize()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        for k, n in launches_of(counters).items():
            launch_totals[k] += n
    reset(counters)
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args([
        "--artifact", art_dir, "--host", "127.0.0.1", "--port", "0",
        "--max_batch", "16", "--device", "cuda"])
    server = serve.build_server(args)
    warm_s = time.perf_counter() - t0
    warm = launches_of(counters)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset(counters)
        answers, lat, wall = http_traffic(
            base, paths, queries, os.path.join(os.path.dirname(art_dir),
                                               "http_artifact"),
            clients=ART_CLIENTS)
        torch.cuda.synchronize()
        got = launches_of(counters)
        stats = server.batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for k in counters:
        launch_totals[k] += warm[k] + got[k]
    x = np.stack([serve._decode_resize(open(p, "rb").read(), args.input_size)
                  for p in paths])
    direct = art.translate_u8(x, np.eye(5, dtype=np.float32)[ks]).cpu()
    steps = []
    for (code, ctype, body), d in zip(answers, direct.numpy()):
        buf = io.BytesIO()
        Image.fromarray(d).save(buf, "JPEG", quality=95)
        o = np.asarray(Image.open(io.BytesIO(body)), np.int16)
        w = np.asarray(Image.open(buf), np.int16)
        steps.append(float(np.abs(o - w).mean()) if o.shape == w.shape
                     else float("inf"))
    rec = {"phase": "eval_serve_artifact", "card": smi, "dtype": "float32",
           "size": args.input_size, "requests": ART_REQUESTS,
           "clients": ART_CLIENTS, "warmup_s": warm_s,
           "warmup_launches": warm, "requests_per_s": ART_REQUESTS / wall,
           "client_p50_ms": float(np.percentile(lat, 50)),
           "client_p90_ms": float(np.percentile(lat, 90)),
           "batches": stats["batches"],
           "mean_batch_size": stats["mean_batch_size"],
           "batch_ms_p50": stats["batch_ms_p50"], "launches": got,
           "max_mean_step_vs_direct": max(steps),
           "requests_per_s_runs_live_vs_artifact": live_rps}
    emit(rec)
    want = {k: 0 for k in counters}
    want.update(adain=3 * stats["batches"], upsample=3 * stats["batches"])
    n_warm = len(serve.warmup_buckets(16))
    want_warm = {k: 0 for k in counters}
    want_warm.update(adain=3 * n_warm, upsample=3 * n_warm)
    if not (all(a[0] == 200 and a[1] == "image/jpeg" for a in answers)
            and rec["max_mean_step_vs_direct"] <= 1.0
            and got == want and warm == want_warm
            and args.input_size == ART_SIZE):
        raise AssertionError(f"serve --artifact: {rec}")


def phase_eval_export(counters, launch_totals, smi):
    """Phase eval_export: FID and IS through Inception-v3 at full width,
    then the exported serving artifact and serve --artifact."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = phase_fid_is(tmp, counters, smi)
        phase_export(tmp, dirs, counters, launch_totals, smi)
    emit({"phase": "eval_export_done",
          "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------------------- surface
SURFACE_SITES = ("upsample3", "upsample2", "upsample1")  # K2_SITES' decoder
PACKED_SHAPE = (8, 256, 56, 56)     # the GAN step's middle decoder level
PACKED_RATE = 0.3                   # the cUNet's dropout rate


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, both on the CPU in float32."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def captured(main, argv):
    """``main(argv)`` of a CLI in this process; what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def surface_upsample(counters, launch_totals, rec, failed):
    """UpsampleBox, use_pallas (K2) against plain, and the upsample's gather
    and shift forms against K2 and F.interpolate, at the decoder's three
    use_pallas upsample inputs in both dtypes; device ms of each."""
    from weather_unet_tpu_torch.kernels import upsample as k2
    from weather_unet_tpu_torch.models import UpsampleBox
    from weather_unet_tpu_torch.ops import resize

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    box, forms = {}, {}
    for site in SURFACE_SITES:
        shape = K2_SITES[site]
        c = shape[1]
        x32 = torch.randn(shape, generator=g, device="cuda")
        for dt in DTYPES:
            x = x32.to(dt)
            r = box[f"{site}_{DT_NAME[dt]}"] = {}
            for train in (False, True):
                mode = "train" if train else "eval"
                plain = UpsampleBox(c).cuda()
                plain.bn.running_mean.normal_(0.0, 1.0, generator=g)
                plain.bn.running_var.uniform_(0.5, 2.0, generator=g)
                fused = UpsampleBox(c, use_pallas=True).cuda()
                fused.load_state_dict(plain.state_dict())
                out, got = counted_run(lambda: fused(x, train=train),
                                       counters, launch_totals)
                if got != {"adain": 0, "upsample": 1, "upconv": 0,
                           "bottleneck": 0}:
                    failed.append(f"UpsampleBox {site} {mode}: launches "
                                  f"{got}")
                ref = plain(x, train=train)
                err = max_err(out, ref)
                tol = TOL_REL[dt] * float(ref.float().abs().max())
                r[f"{mode}_max_abs_err"], r[f"{mode}_tol"] = err, tol
                if not err <= tol:
                    failed.append(f"UpsampleBox {site} {DT_NAME[dt]} {mode}:"
                                  f" {err} > {tol}")
                stats = max(max_err(getattr(fused.bn, n), getattr(plain.bn, n))
                            for n in ("running_mean", "running_var"))
                stats_tol = (1e-5 if dt == torch.float32 else TOL_REL[dt] *
                             float(plain.bn.running_var.abs().max()))
                r[f"{mode}_stats_err"] = stats
                if not stats <= stats_tol:
                    failed.append(f"UpsampleBox {site} {DT_NAME[dt]} {mode} "
                                  f"running statistics: {stats} > "
                                  f"{stats_tol}")
            r["plain_ms"] = device_ms(lambda: plain(x))
            r["use_pallas_ms"] = device_ms(lambda: fused(x))
            # the forms of the upsample alone
            f = forms[f"{site}_{DT_NAME[dt]}"] = {}
            fns = {"k2": k2.upsample2x_fused,
                   "interpolate": resize.upsample_bilinear_align_corners,
                   "gather": resize.upsample_x2_gather,
                   "shift": resize.upsample_x2_shift}
            outs = {name: fn(x) for name, fn in fns.items()}
            for name, fn in fns.items():
                f[f"{name}_ms"] = device_ms(lambda: fn(x))
            for name in ("gather", "shift"):
                if dt == torch.float32:
                    pairs = (("k2", outs["k2"]),
                             ("interpolate", outs["interpolate"]))
                else:   # bfloat16 against its own float32
                    pairs = (("own_f32", fns[name](x32)),)
                for against, ref in pairs:
                    err = max_err(outs[name], ref)
                    tol = TOL_REL[dt] * float(ref.float().abs().max())
                    f[f"{name}_vs_{against}_err"] = err
                    if not err <= tol:
                        failed.append(f"{name} {site} {DT_NAME[dt]} against "
                                      f"{against}: {err} > {tol}")
            del outs
    rec["upsample_box"], rec["upsample_forms"] = box, forms


def surface_modules(rec, failed):
    """DoubleConvDown and ConditionalNorm card against CPU (float32, eval and
    train), packed_dropout's rules on the card, the deterministic
    utils_misc functions card against CPU."""
    from weather_unet_tpu_torch.models import ConditionalNorm, DoubleConvDown
    from weather_unet_tpu_torch.ops import utils_misc as um
    from weather_unet_tpu_torch.ops.dropout import packed_dropout

    gcpu = torch.Generator().manual_seed(SEED + 41)
    down, norm = K2_SITES["upsample1"], K2_SITES["upsample2"]
    mods = {
        "double_conv_down": (
            DoubleConvDown(down[1], 2 * down[1], generator=gcpu),
            (torch.randn(down, generator=gcpu),)),
        "conditional_norm": (
            ConditionalNorm(norm[1], 5),
            (torch.randn(norm, generator=gcpu),
             torch.randint(0, 5, norm[:1], generator=gcpu)))}
    cn = mods["conditional_norm"][0]
    with torch.no_grad():
        cn.embed.normal_(0.0, 1.0, generator=gcpu)
    for name, (cpu_mod, args) in mods.items():
        card_mod = copy.deepcopy(cpu_mod).cuda()
        for train in (False, True):
            mode = "train" if train else "eval"
            with torch.no_grad():
                want = cpu_mod(*args, train=train)
                got = card_mod(*(a.cuda() for a in args), train=train)
            errs = [rel_err(got, want)] + [
                rel_err(getattr(card_mod.bn, n), getattr(cpu_mod.bn, n))
                for n in ("running_mean", "running_var")]
            rec[f"{name}_{mode}_rel_err"] = max(errs)
            if not max(errs) <= 1e-5:
                failed.append(f"{name} {mode} card against CPU: {errs}")
    # packed_dropout: the keep share, the kept values, one mask a seed
    x = torch.randn(PACKED_SHAPE, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))

    def draw(seed):
        return packed_dropout(x, PACKED_RATE, torch.Generator(
            device="cuda").manual_seed(seed))

    a, a2, b = draw(1), draw(1), draw(2)
    thresh = round((1 - PACKED_RATE) * 256)
    p, n = thresh / 256, x.numel()
    keep = a != 0
    share = float(keep.float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    scale = torch.tensor(256 / thresh, dtype=x.dtype, device="cuda")
    rec["packed_dropout"] = {"shape": list(PACKED_SHAPE), "thresh": thresh,
                             "keep_share": share, "want": p, "sigma": sigma}
    if not abs(share - p) <= 4 * sigma:
        failed.append(f"packed_dropout keep share {share} not within 4 sigma "
                      f"of {p}")
    if not torch.equal(a[keep], x[keep] * scale):
        failed.append("packed_dropout kept values are not x * 256/thresh")
    if not torch.equal(a, a2) or torch.equal(keep, b != 0):
        failed.append("packed_dropout: one seed must give one mask, two "
                      "seeds two")
    # utils_misc, card against CPU
    v = torch.randn(6, 5, generator=gcpu)
    img = torch.randn(4, 3, 8, 8, generator=gcpu)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    pairs = {
        "make_one_hot": lambda d: um.make_one_hot(v.to(d), 32),
        "vector_to_one_hot": lambda d: um.vector_to_one_hot(v.to(d)),
        "denormalize": lambda d: um.denormalize(img.to(d), mean, std),
        "get_sequential_labels": lambda d: um.get_sequential_labels(
            5, 16, device=d),
        "get_sequential_labels_one_hot": lambda d: um.get_sequential_labels(
            5, 16, True, device=d),
        "const_batch": lambda d: um.const_batch(1.0, 8, device=d)}
    unequal = [k for k, fn in pairs.items()
               if not torch.equal(fn("cuda").cpu(), fn("cpu"))]
    rec["utils_misc_card_equals_cpu"] = sorted(set(pairs) - set(unequal))
    if unequal:
        failed.append(f"utils_misc card != CPU: {unequal}")


def surface_host_tools(rec, failed):
    """The four host CLIs over a fresh serving world, in this process: the
    preprocess subcommands' pickles against the same calls of
    data/preprocess.py, pkl_viewer on each, write_image_summary over a
    short SummaryWriter run (one JPEG an event), plot_signals (a PNG where
    matplotlib is present, else its refusal)."""
    import pandas as pd
    from PIL import Image

    from weather_unet_tpu_torch.cli import (
        pkl_viewer, plot_signals, preprocess, write_image_summary)
    from weather_unet_tpu_torch.data import preprocess as pp
    from weather_unet_tpu_torch.data.datasets import SIGNAL_COLUMNS
    from weather_unet_tpu_torch.train.metrics import SummaryWriter

    with tempfile.TemporaryDirectory() as tmp:
        world = serving_world(tmp)
        # one gray photo and one missing, which remove-gray must drop
        gray = np.repeat(np.random.default_rng(SEED + 42).integers(
            0, 255, (64, 64, 1), dtype=np.uint8), 3, axis=2)
        Image.fromarray(gray).save(os.path.join(world["photos"], "gray.jpg"),
                                   quality=100, subsampling=0)
        frame = pd.read_pickle(world["frame"])
        extra = frame.iloc[:2].copy()
        extra["photo"] = ["gray", "missing"]
        gray_frame = os.path.join(tmp, "frame_gray.pkl")
        pd.concat([frame, extra], ignore_index=True).to_pickle(gray_frame)
        out = {k: os.path.join(tmp, f"{k}.pkl")
               for k in ("split-i2w", "split-flickr", "remove-gray")}
        argv = {"split-i2w": ["--root", os.path.join(tmp, "i2w"),
                              "--test_per_class", "2"],
                "split-flickr": ["--pkl_path", world["frame"]],
                "remove-gray": ["--pkl_path", gray_frame, "--image_root",
                                world["photos"]]}
        printed = {cmd: captured(preprocess.main, [cmd] + a + [
            "--output", out[cmd]]) for cmd, a in argv.items()}
        want = {"split-i2w": pp.split_i2w(os.path.join(tmp, "i2w"), 2),
                "split-flickr": pp.split_flickr(frame),
                "remove-gray": pp.remove_gray(pd.read_pickle(gray_frame),
                                              world["photos"])}
        for cmd, w in want.items():
            got = pd.read_pickle(out[cmd])
            same = (got == w if isinstance(w, dict)
                    else got.equals(w) and list(got.columns) == list(
                        w.columns))
            if not same:
                failed.append(f"preprocess {cmd}: the pickle differs from "
                              "the same call in this process")
        kept = want["remove-gray"]["photo"].tolist()
        if "gray" in kept or "missing" in kept or len(kept) != len(frame):
            failed.append(f"remove-gray kept {len(kept)} rows")
        rec["preprocess_printed"] = {k: v.strip() for k, v in
                                     printed.items()}
        views = {cmd: captured(pkl_viewer.main, [p]) for cmd, p in
                 out.items()}
        rec["pkl_viewer_first_lines"] = {k: v.splitlines()[0]
                                         for k, v in views.items()}
        if [v.splitlines()[0] for v in views.values()] != [
                "type: dict", "type: DataFrame", "type: DataFrame"]:
            failed.append(f"pkl_viewer: {rec['pkl_viewer_first_lines']}")
        # write_image_summary over the port's own image events
        rng = np.random.default_rng(SEED + 43)
        writer = SummaryWriter(os.path.join(tmp, "runs"))
        events = 0
        for step in (0, 4, 8):
            writer.add_image_grid("images/train", rng.random((4, 64, 64, 3)),
                                  step, nrow=2)
            events += 1
        writer.close()
        jpg_dir = os.path.join(tmp, "summary_images")
        try:
            text = captured(write_image_summary.main, [
                "--event_path", writer.log_dir, "--output_dir", jpg_dir])
        except SystemExit as e:
            text = f"refused: {e}"
        jpgs = sorted(glob.glob(os.path.join(jpg_dir, "*.jpg")))
        rec["write_image_summary"] = {"printed": text.strip(),
                                      "jpegs": len(jpgs), "events": events}
        if len(jpgs) != events or any(Image.open(p).format != "JPEG"
                                      for p in jpgs):
            failed.append(f"write_image_summary: {rec['write_image_summary']}")
        # plot_signals
        gt = os.path.join(tmp, "gt.pkl")
        pd.to_pickle(frame[SIGNAL_COLUMNS].to_numpy(), gt)
        png = os.path.join(tmp, "signals.png")
        has_mpl = host_packages()["matplotlib"]
        try:
            text = captured(plot_signals.main, ["--gt_pkl", gt, "--output",
                                                png])
            result = "png" if os.path.exists(png) else "no file"
        except SystemExit as e:
            result = f"refused: {e}"
        rec["matplotlib"], rec["plot_signals"] = has_mpl, result
        if has_mpl and result != "png":
            failed.append(f"plot_signals with matplotlib {has_mpl}: {result}")
        if not has_mpl and not (result.startswith("refused")
                                and "matplotlib" in result):
            failed.append(f"plot_signals without matplotlib: {result}")


def phase_surface(counters, launch_totals, smi):
    """Phase surface: the reference-surface ops and modules no model path
    calls, on the card (UpsampleBox through K2), and the host tools."""
    t_phase = time.perf_counter()
    rec, failed = {"phase": "surface", "card": smi}, []
    surface_upsample(counters, launch_totals, rec, failed)
    surface_modules(rec, failed)
    surface_host_tools(rec, failed)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    require("surface", rec, failed)
    free_cuda()


# ------------------------------------------------------------------ parallel
DP_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "dp_train_torch.py")
DP_SIZE, DP_BATCH, DP_STEPS = 224, 8, 3   # the est trainer's defaults
DP_SUP_BATCH, DP_SUP_STEPS = 64, 2        # train_estimator's default batch
DP_TIMEOUT = 400                          # seconds for one multi-rank run


def dp_env():
    """The ranks' environment: this checkout on the path, no inherited
    launcher contract, a collective timeout well inside the run's."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("WUT_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["WUT_BARRIER_TIMEOUT_S"] = "300"
    return env


def dp_run(n, argv, logs, backend=None):
    """``argv`` of the worker as ``n`` ranks through the launcher (n > 0)
    or as one plain process (n == 0); raises with the logs' tails unless
    every process ends with 0.  Returns the rank records."""
    from weather_unet_tpu_torch.parallel.launch import launch_local

    out = argv[argv.index("--out") + 1]
    cmd = [sys.executable, DP_WORKER] + argv
    os.makedirs(logs, exist_ok=True)
    if n:
        rc = launch_local(n, cmd, backend=backend, env=dp_env(),
                          timeout=DP_TIMEOUT, rank_logs=logs)
    else:
        with open(os.path.join(logs, "rank0.log"), "wb") as f:
            rc = subprocess.run(cmd, env=dp_env(), stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=DP_TIMEOUT).returncode
    if rc != 0:
        tails = []
        for log in sorted(glob.glob(os.path.join(logs, "*.log"))):
            with open(log, errors="replace") as f:
                tails.append(f"--- {log}\n" + f.read()[-3000:])
        raise AssertionError(f"worker {argv[:4]} x{n}: rc {rc}\n"
                             + "\n".join(tails))
    recs = []
    for r in range(max(n, 1)):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def dp_bytes(out, r=0):
    with open(os.path.join(out, f"rank{r}.pt"), "rb") as f:
        return f.read()


def dp_worker_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("dp_train_torch",
                                                  DP_WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dp_concurrently(*calls):
    """Run the zero-argument ``calls`` in threads at once (each starts its
    own processes on the card); their results in order, the first error
    raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futs = [pool.submit(c) for c in calls]
        return [f.result() for f in futs]


def dp_gan_parity(tmp, est_path, out, seed="0", route="k4", rec=None):
    """(b) each f32 step k of the data-parallel ranks (model ``seed``, the
    estimator by ``route``) against the one-process step at global B
    (gan_step_parity) from the seeded state or rank 0's state after step
    k - 1, on the ranks' inputs of step k joined.  Besides the float32
    floors, the estimator route's sensitivity to the batch being split
    (each rank's estimator at B/2 against B) is added to the bars."""
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    cfg = GanConfig(input_size=DP_SIZE, batch_size=DP_BATCH, num_epoch=1,
                    dropout_rate=0.0)
    _, _, ranks = build_gan_state(cfg, int(seed), "cuda", use_pallas=True)
    init = os.path.join(tmp, f"dp_init{seed}.pt")
    with open(init, "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(ranks,
                                                            int(seed)))))
    est = estimators(est_path, torch.float32, route, {})
    half = DP_BATCH // 2

    def split(x):
        return torch.cat([est(x[:half]), est(x[half:])])

    def case(k):
        rows = [torch.load(os.path.join(out, f"rank{r}_in{k}.pt"),
                           weights_only=True) for r in range(2)]
        inputs = tuple(torch.cat(ts) for ts in zip(*rows))
        ckpt.restore_checkpoint(os.path.join(out, f"rank0_s{k}.pt"), ranks)
        return ("parallel (b)", None, inputs,
                gan_snapshot(ranks, rec["b_metrics"][k - 1]))

    def extra(inputs):
        x, _, r, _ = (t.cuda() for t in inputs)
        return 2 * route_sensitivity(est, split, x, r, cfg.con_eps)[0]

    rec["b_parity"], rec["b_refused_allocations_in_reference"] = (
        gan_step_parity("parallel (b)", cfg, est, DP_STEPS, init, out, case,
                        extra=extra))
    del ranks, est
    free_cuda()


def dp_sup_parity(out, recs, rec):
    """The two ranks' estimator-CLI steps k against the one-process step
    on their joined rows from rank 0's state after step k - 1: losses rel
    1e-4; BatchNorm's running statistics within 1e-5 and parameters within
    the sign-flip bound (fewer than 0.5% beyond 5e-5, none beyond 2.2 * lr
    * sqrt(k)), each plus twice the one-process step's own float32 floor
    (the same step with its input moved by one rounding, in this call):
    at full width and B=64, ResNet-101's step flips the sign of ~1% of its
    Adam updates and moves its BatchNorm statistics (up to ~56) by ~6e-5
    under one rounding of its input (on an H100), so no two float32
    computations of it meet 0.5% and 1e-5 alone."""
    from weather_unet_tpu_torch.models import ResNet101
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import supervised as sup

    def fresh():
        model = ResNet101(5, param_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
        return sup.build_supervised_state(model.cuda(), 1e-4, 1e-5)

    ref, moved, got = fresh(), fresh(), fresh()
    init = ckpt._to_host(ckpt.supervised_tree(ref, 0, 0))  # the CLI's

    def bn_err(a, b):
        sa, sb = a.module.state_dict(), b.module.state_dict()
        return max(float((sa[n].float() - sb[n].float()).abs().max())
                   for n in sb if n.endswith(("running_mean",
                                              "running_var")))

    steps = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True       # as the ranks run
    for k in range(1, DP_SUP_STEPS + 1):
        parts = [torch.load(os.path.join(out, f"rank{r}_in{k}.pt"),
                            weights_only=True) for r in (0, 1)]
        x = torch.cat([p[0] for p in parts]).cuda()
        t = torch.cat([p[1] for p in parts]).cuda()

        def one(st, images):
            if k == 1:
                st.module.load_state_dict(init["model"])
                st.optimizer.load_state_dict(init["opt"])
                st.step = 0
            else:
                ckpt.restore_supervised(
                    os.path.join(out, f"rank0_s{k - 1}.pt"), st)
            return sup.make_estimator_step()(st, images, t)

        ref, m = one(ref, x)
        moved, _ = one(moved, x * (1 + ONE_ROUNDING))
        floor = {"bn": bn_err(moved, ref),
                 **sup_params_agree(moved, ref, 1e-4 * np.sqrt(k))}
        ckpt.restore_supervised(os.path.join(out, f"rank0_s{k}.pt"), got)
        loss_rel = {n: abs(recs[0]["metrics"][k - 1][n] - float(v))
                    / max(abs(float(v)), 1e-30) for n, v in m.items()}
        bn = bn_err(got, ref)
        params = sup_params_agree(got, ref, 1e-4 * np.sqrt(k))
        steps.append({"loss_rel_err": loss_rel, "bn_max_abs_err": bn,
                      **params, "float32_floor": floor})
        if not (max(loss_rel.values()) <= 1e-4
                and bn <= 1e-5 + 2 * floor["bn"]
                and params["loose_share"] < 5e-3 + 2 * floor["loose_share"]
                and params["max_move_diff"] <= 2.2e-4 * np.sqrt(k) + 1e-6):
            raise AssertionError(f"parallel (c) step {k}: {steps[-1]}")
    del ref, moved, got
    torch.backends.cudnn.deterministic = deterministic
    rec["c_parity"] = steps
    free_cuda()


def dp_replicas(cunet_path, counters, launch_totals, rec):
    """(d) WeatherTransfer with two replicas on cuda:0 against one, f32 and
    bf16, 256², B=16: MAE <= 1e-5 against one replica at the replicas'
    batch of 8 (and at 16: 1e-5 in f32, bf16's 1e-3 in bf16, where cuDNN
    may pick another algorithm), K1 and K2 3 launches a replica forward;
    serve --data_parallel (a replica on each local card) answers 16 POSTs
    from 4 clients."""
    import threading
    import urllib.request

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli import serve
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    plan = make_mesh(devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, 256, 256, 3)).astype(
        np.float32)).cuda()
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(
        0, 5, 16)]).cuda()
    out = {}
    for dt in DTYPES:
        one = WeatherTransfer.load(cunet_path, dtype=dt, device="cuda")
        two = WeatherTransfer.load(cunet_path, dtype=dt, plan=plan)
        ref = one.translate(x.to(dt), c)
        got, launches = counted_run(lambda: two.translate(x.to(dt), c),
                                    counters, launch_totals,
                                    {"adain": 6, "upsample": 6},
                                    f"two replicas {DT_NAME[dt]}")
        # one replica at the replicas' shape (8 rows a forward), and at 16
        halves = torch.cat([one.translate(x[:8].to(dt), c[:8]),
                            one.translate(x[8:].to(dt), c[8:])])
        mae = float((got.float() - halves.float()).abs().mean())
        mae16 = float((got.float() - ref.float()).abs().mean())
        out[DT_NAME[dt]] = {
            "mae": mae, "mae_against_b16": mae16, "launches": launches,
            "ms_two_replicas": wall_ms(lambda: two.translate(x.to(dt), c)),
            "ms_one": wall_ms(lambda: one.translate(x.to(dt), c))}
        # at B=16 cuDNN may pick other algorithms than at 8: bf16's bar
        bar16 = 1e-5 if dt == torch.float32 else 1e-3
        if not (mae <= 1e-5 and mae16 <= bar16):
            raise AssertionError(f"two replicas {DT_NAME[dt]}: "
                                 f"{out[DT_NAME[dt]]}")
        del one, two, ref, got, halves
    rec["d_replicas"] = out
    free_cuda()

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (256, 256, 3), np.uint8)).save(
        buf, format="JPEG")
    body = buf.getvalue()
    server = serve.build_server(serve.build_parser().parse_args(
        ["--cp_path", cunet_path, "--host", "127.0.0.1", "--port", "0",
         "--input_size", "224", "--data_parallel"]))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    codes = []

    def client(n):
        for _ in range(n):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}"
                "/translate?class=rain", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                codes.append((resp.status, len(resp.read())))

    try:
        def traffic():
            ts = [threading.Thread(target=client, args=(4,))
                  for _ in range(4)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()

        t0 = time.perf_counter()
        _, launches = counted_run(traffic, counters, launch_totals)
        seconds = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        t.join(30)
    rec["d_serve"] = {"replicas": len(server.transfer._replicas),
                      "mesh": server.transfer.plan.mesh_shape,
                      "answers": len(codes), "seconds": seconds,
                      "launches": launches}
    if len(codes) != 16 or any(s != 200 or n == 0 for s, n in codes):
        raise AssertionError(f"serve --data_parallel: {codes}")
    if launches["adain"] == 0 or launches["upsample"] == 0:
        raise AssertionError(f"serve --data_parallel launches {launches}")
    del server
    free_cuda()


def phase_parallel(cunet_path, est_path, counters, launch_totals, smi):
    """Phase parallel: the multi-process runtime and data parallelism
    (parallel/launch.py, parallel/mesh.py) on the card, the ranks in child
    processes of tools/dp_train_torch.py.  (a) NCCL at world size 1
    through the launcher: the est trainer, 3 steps at 224², B=8, f32 (TF32
    off, cuDNN deterministic), dropout 0, K1, K2 and the K4-routed
    estimator, its checkpoint bit-equal to the same run without the
    launcher.  (b) Two gloo ranks on cuda:0, the same run at global B=8,
    alone on the card: the ranks' checkpoints byte-equal, each step held
    to the one-process step (dp_gan_parity, in a child process).  (c)
    Two gloo ranks: train_estimator, 2 steps at 224², global B=64, f32,
    against the one-process step (dp_sup_parity).  (d) dp_replicas.  The
    ranks' K1, K2 and K4 launches join the main-path totals."""
    t_phase = time.perf_counter()
    modes = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(modes, flush=True)
    rec = {"phase": "parallel", "card": smi, "nvidia_smi": modes}
    if not modes.endswith("Default"):
        raise AssertionError(f"parallel: the card's compute mode forbids a "
                             f"second process on it ({modes})")
    free_cuda()
    tmp = tempfile.mkdtemp(prefix="wut_dp_")
    try:
        gan = ["--mode", "gan", "--size", str(DP_SIZE), "--batch",
               str(DP_BATCH), "--steps", str(DP_STEPS), "--estimator_path",
               est_path, "--route", "k4"]
        f32 = gan + ["--deterministic"]

        def at(name):
            return ["--out", os.path.join(tmp, name), "--save_dir",
                    os.path.join(tmp, "cp_" + name)]

        logs = os.path.join(tmp, "logs")
        # (c)'s world: the estimator CLI over 128 train rows (2 steps of
        # 64) and 8 test rows
        import pandas as pd

        t0 = time.perf_counter()
        jpegs = os.path.join(tmp, "jpegs")
        os.makedirs(jpegs)
        n = 2 * DP_SUP_BATCH + 8
        write_jpegs(jpegs, n)
        sig = np.random.default_rng(SEED + 15).standard_normal((n, 5))
        classes = ["Clear", "Clouds", "Rain", "Mist", "Snow"]
        frame = os.path.join(tmp, "frame.pkl")
        pd.DataFrame({
            "photo": [f"{i:03d}" for i in range(n)],
            "mode": ["train"] * (n - 8) + ["test"] * 8,
            **{c: sig[:, j] for j, c in enumerate(
                ["clouds", "temp", "humidity", "pressure", "windspeed"])},
            "w_condition": [classes[i % 5] for i in range(n)],
            "condition2": [classes[i % 5] for i in range(n)]}).to_pickle(
            frame)
        cli = ["--out", os.path.join(tmp, "c"), "--mode", "cli",
               "--deterministic", "--snapshots", "--dump_inputs", "--",
               "--image_root", jpegs, "--pkl_path", frame, "-bs",
               str(DP_SUP_BATCH), "--num_epoch", "1", "--num_workers", "4",
               "--save_path", os.path.join(tmp, "cp_c"), "--log_dir",
               os.path.join(tmp, "runs"), "--name", "est"]
        # the f32 runs of (a) and (c) at once (none of them is timed), then
        # (b) alone on the card: ranks started beside others can find no
        # room for a cuDNN workspace and run another engine (F1), which
        # their refused-allocation counts would show
        a1, a0, c = dp_concurrently(
            lambda: dp_run(1, at("a1") + f32, os.path.join(logs, "a1")),
            lambda: dp_run(0, at("a0") + f32 + ["--device", "cuda"],
                           os.path.join(logs, "a0")),
            lambda: dp_run(2, cli, os.path.join(logs, "c"), backend="gloo"))
        rec["a_c_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = dp_run(2, at("b") + f32 + ["--snapshots", "--dump_inputs"],
                   os.path.join(logs, "b"), backend="gloo")
        rec["b_seconds"] = time.perf_counter() - t0
        rec["b_refused_allocations"] = [r["refused_allocations"] for r in b]
        if any(rec["b_refused_allocations"]):
            raise AssertionError(f"parallel (b): refused allocations "
                                 f"{rec['b_refused_allocations']} (F1)")
        with open(os.path.join(logs, "a1", "rank0.log"),
                  errors="replace") as f:
            if "(nccl, cuda:0)" not in f.read():
                raise AssertionError("(a) did not join an NCCL group")
        same_a = dp_bytes(os.path.join(tmp, "a1")) == dp_bytes(
            os.path.join(tmp, "a0"))
        same_b = dp_bytes(os.path.join(tmp, "b"), 0) == dp_bytes(
            os.path.join(tmp, "b"), 1)
        rec["a"] = {"world": a1[0]["world"], "bit_equal_to_plain": same_a,
                    "launches": a1[0]["launches"],
                    "metrics": a1[0]["metrics"]}
        rec["b"] = {"ranks_byte_equal": same_b,
                    "launches": [r["launches"] for r in b]}
        if not (same_a and a1[0]["metrics"] == a0[0]["metrics"]):
            raise AssertionError(f"(a) world 1 through the launcher != the "
                                 f"plain run: {rec['a']}")
        if not same_b:
            raise AssertionError("(b) the two ranks' checkpoints differ")
        if len(c[0]["metrics"]) != DP_SUP_STEPS or dp_bytes(
                os.path.join(tmp, "c"), 0) != dp_bytes(
                os.path.join(tmp, "c"), 1):
            raise AssertionError(f"(c) ranks: {c[0]['metrics']}")
        for r in a1 + b:
            for k in ("adain", "upsample", "bottleneck"):
                launch_totals[k] += r["launches"][k]
        want = {"adain": 6 * DP_STEPS, "upsample": 6 * DP_STEPS}
        for r in a1 + b:
            if {k: r["launches"][k] for k in want} != want or (
                    r["launches"]["bottleneck"] == 0):
                raise AssertionError(f"rank launches {r['launches']}")
        t0 = time.perf_counter()
        rec["b_metrics"] = b[0]["metrics"]
        parity_child("dp_gan_parity", (tmp, est_path, os.path.join(
            tmp, "b")), tmp, rec, ("b_parity",
                                   "b_refused_allocations_in_reference"))
        dp_sup_parity(os.path.join(tmp, "c"), c, rec)
        rec["b_c_parity_seconds"] = time.perf_counter() - t0
        # no bf16 timing run of the two data-parallel ranks here (CUTS):
        # phase tensor_parallel times two ranks' bf16 steps
        t0 = time.perf_counter()
        dp_replicas(cunet_path, counters, launch_totals, rec)
        rec["d_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


# ---------------------------------------------------------- tensor_parallel
TP_SIZE, TP_BATCH, TP_STEPS = 224, 8, 3   # the est trainer's defaults
TP_SERVE_SIZE, TP_SERVE_BATCH = 256, 16
TP_JPEGS = 36          # 70% of them train: 3 steps of 8


def tp_serving(cunet_path, counters, launch_totals, rec):
    """(a) the in-process split on cuda:0 twice, and data=2, model=2."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.parallel import tp
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(SEED + 50)
    b, size = TP_SERVE_BATCH, TP_SERVE_SIZE
    x = torch.from_numpy(rng.uniform(-1, 1, (b, size, size, 3)).astype(
        np.float32)).cuda()
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(
        0, 5, b)]).cuda()
    u8 = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    plan = make_mesh(["cuda:0", "cuda:0"], data=1, model=2)
    out, f32 = {}, None
    for dt in DTYPES:
        one = WeatherTransfer.load(cunet_path, dtype=dt, device="cuda")
        two = WeatherTransfer.load(cunet_path, dtype=dt, plan=plan,
                                   tensor_parallel=True)
        group = two._groups[0]
        before = group.pair_sums
        got, launches = counted_run(
            lambda: two.translate(x.to(dt), c), counters, launch_totals,
            {"adain": 6, "upsample": 6}, f"split {DT_NAME[dt]}")
        sums = group.pair_sums - before
        ref = one.translate(x.to(dt), c)
        r = {"launches": launches, "pair_sums_a_forward": sums,
             "mae_against_unsharded": float(
                 (got.float() - ref.float()).abs().mean()),
             "shard_weight_mib": [tp.weight_bytes(m) / 2 ** 20
                                  for m in two._replicas],
             "whole_weight_mib": tp.weight_bytes(one.model) / 2 ** 20,
             "ms_split": wall_ms(lambda: two.translate(x.to(dt), c)),
             "ms_unsharded": wall_ms(lambda: one.translate(x.to(dt), c))}
        if dt == torch.float32:
            f32 = got.float()
            w8 = two.translate_u8(u8, c).to(torch.int16)
            r["u8_max_diff"] = int((w8 - one.translate_u8(u8, c).to(
                torch.int16)).abs().max())
            # item 4d: the AOT tier over the split model, each shape's
            # program the eager split forward, bit-equal to the untiered
            with tempfile.TemporaryDirectory() as aot_dir:
                tiered = WeatherTransfer.load(cunet_path, dtype=dt,
                                              plan=plan, tensor_parallel=True,
                                              aot_cache=aot_dir)
                r["aot_tier"] = {
                    "bit_equal_to_untiered": bool(torch.equal(
                        tiered.translate(x, c), got))
                    and bool(torch.equal(tiered.translate_u8(u8, c).to(
                        torch.int16), w8)),
                    "stats": dict(tiered.aot.stats),
                    "files_written": len(os.listdir(aot_dir))}
                del tiered
            ok = (r["mae_against_unsharded"] <= 1e-5 and r["u8_max_diff"] <= 1
                  and r["aot_tier"]["bit_equal_to_untiered"]
                  and r["aot_tier"]["stats"]["captures"] == 0
                  and r["aot_tier"]["stats"]["programs"] == 2
                  and r["aot_tier"]["files_written"] == 0)
        else:
            r["mae_against_own_float32"] = float(
                (got.float() - f32).abs().mean())
            ok = r["mae_against_own_float32"] <= 1e-3
        out[DT_NAME[dt]] = r
        if not (ok and sums == 7):
            raise AssertionError(f"tensor_parallel (a) {DT_NAME[dt]}: {r}")
        del one, two, ref, got
    rows = make_mesh(["cuda:0"] * 4, data=2, model=2)
    four = WeatherTransfer.load(cunet_path, plan=rows, tensor_parallel=True)
    got, launches = counted_run(lambda: four.translate(x, c), counters,
                                launch_totals, {"adain": 12, "upsample": 12},
                                "data=2, model=2")
    r = {"launches": launches,
         "pair_sums": [g.pair_sums for g in four._groups],
         "mae_against_unsharded": float((got.float() - f32).abs().mean())}
    out["data2_model2"] = r
    if not (r["mae_against_unsharded"] <= 1e-5 and r["pair_sums"] == [7, 7]):
        raise AssertionError(f"tensor_parallel (a) data=2, model=2: {r}")
    rec["a_serving"] = out
    del four, got
    free_cuda()


def tp_cli_world(tmp):
    """The est CLI's world: TP_JPEGS seeded 256x256 JPEGs (--image_only:
    the first 70% train, in order of their sorted names) under ``tmp``.
    Returns their root relative to ``tmp``, from where the CLI runs: the
    train augmentation's streams are keyed on each image's path, so a root
    under tempfile's random name drew other augmentations in every run."""
    os.makedirs(os.path.join(tmp, "tp_jpegs"))
    write_jpegs(os.path.join(tmp, "tp_jpegs"), TP_JPEGS, seed=SEED + 51)
    return "tp_jpegs"


def no_refusal(what, before):
    """F1: raise, before a parity bar is read, where the card refused an
    allocation since ``before`` (``_device.refused_allocations``): a
    refused cuDNN workspace runs another engine, so the step compared is
    not the one a card with room computes."""
    from weather_unet_tpu_torch._device import refused_allocations

    n = refused_allocations() - before
    if n:
        raise AssertionError(
            f"{what}: the card refused {n} allocation(s) during the "
            f"reference steps ({torch.cuda.mem_get_info()[0] / 2 ** 20:.0f} "
            f"MiB free now): another cuDNN engine ran (F1)")


def f1_step_digest(init, est_path, out):
    """F1: the one-process f32 reference step 1 of (b), from ``init`` on
    rank 0's inputs of step 1, as tp_step_parity takes it; the digest of
    the state it leaves and the allocations the card refused meanwhile."""
    from weather_unet_tpu_torch._device import refused_allocations
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)

    cfg = GanConfig(input_size=TP_SIZE, batch_size=TP_BATCH, num_epoch=1)
    gen, disc, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    ckpt.restore_checkpoint(init, state)
    step = make_gan_step(gen, disc, estimators(
        est_path, torch.float32, "k4", {}), cfg)
    x, c_d, r, c_r = (t.cuda() for t in torch.load(
        os.path.join(out, "rank0_in1.pt"), weights_only=True))
    g = torch.Generator(device="cuda").manual_seed(fold_seed(1, 1))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True       # as the ranks run
    refused = refused_allocations()
    st, _ = step(state, x, c_d, r, c_r, g, do_g=True)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = deterministic
    tree = ckpt.serialize(ckpt._to_host(ckpt.gan_tree(st, 0)))
    return {"digest": hashlib.sha256(tree).hexdigest()[:16],
            "refused_allocations": refused_allocations() - refused}


def gan_step_parity(what, cfg, est, n_steps, init, out, case, extra=None):
    """Each f32 step k (1..n_steps) of parallel ranks against the
    one-process step from the state they took it from, at the GAN f32
    bars (gan_states_agree) with the float32 floor the larger of two: the
    step with its input moved by one rounding (float32_floor), and the
    step with every weight moved by one rounding, which re-rounds every
    conv's output as a split does (a tensor-parallel split's partial sums,
    a spatial split's halos, a batch split's other cuDNN and cuBLAS
    engines at the ranks' batch).  ``case(k)`` gives step k's label, start
    state (None: ``init`` at k = 1, else rank 0's after step k - 1), the
    one-process step's inputs and the ranks' snapshot; ``extra(inputs)``,
    where given, is added to every bar.  No allocation may be refused
    during the reference steps (F1).  Returns the steps' records and the
    allocations refused."""
    from weather_unet_tpu_torch._device import refused_allocations
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        build_gan_state, make_gan_step)

    gen, disc, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    step = make_gan_step(gen, disc, est, cfg)
    g = torch.Generator(device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True       # as the ranks run
    refused = refused_allocations()

    def one_step(start, k, inputs, scale=1.0, weight_scale=1.0):
        x, c_d, r, c_r = (t.cuda() for t in inputs)
        ckpt.restore_checkpoint(start, state)
        if weight_scale != 1.0:
            with torch.no_grad():
                for ts in (state.gen, state.disc):
                    for p in ts.module.parameters():
                        p.mul_(weight_scale)
        g.manual_seed(fold_seed(1, k))               # seed + 1, step k
        st, m = step(state, x * scale, c_d, r, c_r, g, do_g=True)
        return gan_snapshot(st, m)

    steps = []
    for k in range(1, n_steps + 1):
        label, start, inputs, got = case(k)
        if start is None:
            start = init if k == 1 else os.path.join(
                out, f"rank0_s{k - 1}.pt")
        want = one_step(start, k, inputs)
        parts = {"input": float32_floor(lambda xs: one_step(start, k, (
            xs.cpu(), *inputs[1:])), inputs[0].cuda(), want)}
        errs = [snapshot_errs(one_step(start, k, inputs, weight_scale=(
            1 + sign * ONE_ROUNDING)), want) for sign in (1, -1)]
        parts["weights"] = {key: max(e[key] for e in errs)
                            for key in MOMENT_KEYS}
        floor = {key: max(f[key] for f in parts.values())
                 for key in MOMENT_KEYS}
        no_refusal(what, refused)
        steps.append(gan_states_agree(
            got, want, cfg.lr * np.sqrt(k), GAN_TOL,
            f"{label} step {k} against the one-process step", floor,
            extra=extra(inputs) if extra else 0.0))
        steps[-1]["float32_floors"] = parts
    torch.backends.cudnn.deterministic = deterministic
    del gen, disc, state, step
    free_cuda()
    return steps, refused_allocations() - refused


def tp_step_parity(tmp, est_path, out, rec):
    """(b) each f32 step k of the split ranks against the one-process step
    (gan_step_parity) on rank 0's inputs of step k and the trainer's
    dropout seed of step k; (c) the TP checkpoint loaded without tensor
    parallelism: bit-equal, and one more step at the same bars."""
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)

    cfg = GanConfig(input_size=TP_SIZE, batch_size=TP_BATCH, num_epoch=1)
    _, _, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    _, _, ranks = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    init = os.path.join(tmp, "tp_init.pt")
    with open(init, "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
    del state
    est = estimators(est_path, torch.float32, "k4", {})

    def case(k):
        inputs = torch.load(os.path.join(out, f"rank0_in{min(k, TP_STEPS)}"
                                         ".pt"), weights_only=True)
        if k <= TP_STEPS:
            ckpt.restore_checkpoint(os.path.join(out, f"rank0_s{k}.pt"),
                                    ranks)
            return ("tensor_parallel (b)", None, inputs,
                    gan_snapshot(ranks, rec["b_metrics"][k - 1]))
        start = os.path.join(out, "rank0.pt")                  # (c)
        with open(start, "rb") as f:
            saved = f.read()
        ckpt.restore_checkpoint(start, ranks)
        rec["c_bit_equal_on_load"] = ckpt.serialize(ckpt._to_host(
            ckpt.gan_tree(ranks, 0))) == saved
        if not rec["c_bit_equal_on_load"]:
            raise AssertionError("tensor_parallel (c): the TP=2 "
                                 "checkpoint does not load bit-equal")
        g = torch.Generator(device="cuda").manual_seed(fold_seed(1, k))
        x, c_d, r, c_r = (t.cuda() for t in inputs)
        ranks_step = make_gan_step(ranks.gen.module, ranks.disc.module,
                                   est, cfg)
        _, m = ranks_step(ranks, x, c_d, r, c_r, g, do_g=True)
        return ("tensor_parallel (c) resumed", start, inputs,
                gan_snapshot(ranks, m))

    steps, rec["b_refused_allocations_in_reference"] = gan_step_parity(
        "tensor_parallel (b)", cfg, est, TP_STEPS + 1, init, out, case)
    rec["b_parity"], rec["c_parity"] = steps[:-1], steps[-1]
    del ranks, est
    free_cuda()
    rec["f1_fresh_process"] = f1_step_digest(init, est_path, out)


# A parity function of this script in a process of its own: argv root,
# the function's name, the record's path, then the function's arguments.
# In a whole run of the script the one-process float32 steps, taken in
# this process after its earlier phases and beside starting ranks, moved
# D's moments 7.5x their float32 floor from the split ranks (whose bytes
# were the same in three runs), while the same steps in a fresh process
# met their bars
PARITY_CHILD = ("import json, sys, torch\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "import chip_smoke as cs\n"
                "torch.backends.cudnn.allow_tf32 = False\n"
                "torch.backends.cuda.matmul.allow_tf32 = False\n"
                "with open(sys.argv[3]) as f:\n"
                "    rec = json.load(f)\n"
                "getattr(cs, sys.argv[2])(*sys.argv[4:], rec=rec)\n"
                "with open(sys.argv[3], 'w') as f:\n"
                "    json.dump(rec, f)\n")


def parity_child(fn, args, tmp, rec, keys):
    """``fn(*args, rec=...)`` of this script in a child process, given
    ``rec``'s b_metrics; its records under ``keys`` join ``rec``."""
    path = os.path.join(tmp, f"{fn}.json")
    with open(path, "w") as f:
        json.dump({"b_metrics": rec["b_metrics"]}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    free_cuda()
    rec["b_free_mib_before_parity"] = (torch.cuda.mem_get_info()[0]
                                       / 2 ** 20)
    res = subprocess.run(
        [sys.executable, "-c", PARITY_CHILD, root, fn, path, *args],
        env=dp_env(), capture_output=True, text=True, timeout=DP_TIMEOUT)
    if res.returncode != 0:
        raise AssertionError(f"{fn} (rc {res.returncode}): "
                             f"{res.stderr[-3000:]}")
    with open(path) as f:
        got = json.load(f)
    for key in keys:
        rec[key] = got[key]


def phase_tensor_parallel(cunet_path, est_path, counters, launch_totals,
                          smi):
    """Phase tensor_parallel (module docstring, 11c)."""
    t_phase = time.perf_counter()
    rec = {"phase": "tensor_parallel", "card": smi}
    free_cuda()
    t0 = time.perf_counter()
    tp_serving(cunet_path, counters, launch_totals, rec)
    rec["a_seconds"] = time.perf_counter() - t0
    emit({**rec, "phase": "tensor_parallel_serving"})
    tmp = tempfile.mkdtemp(prefix="wut_tp_")
    try:
        root = tp_cli_world(tmp)
        logs = os.path.join(tmp, "logs")

        def cli(name, dtype, timing=False):
            out = os.path.join(tmp, name)
            # TF32 off and cuDNN deterministic, as this process runs
            return ["--out", out, "--mode", "est_cli", "--route", "k4",
                    "--snapshots", "--dump_inputs", "--deterministic"] + (
                ["--timing"] if timing else []) + [
                "--", "--image_root", root, "--image_only",
                "--estimator_path", est_path, "--input_size", str(TP_SIZE),
                "--batch_size", str(TP_BATCH), "--num_epoch", "1",
                "--num_workers", "4", "--dtype", dtype,
                "--save_dir", os.path.join(tmp, "cp_" + name),
                "--log_dir", os.path.join(tmp, "runs"),
                "--tensor_parallel", "2"]

        # (d) keys rows and masks: the worker's linear estimator stands
        # in for ResNet-101, which (b) runs through K4
        four = ["--out", os.path.join(tmp, "d"), "--mode", "gan", "--size",
                str(TP_SIZE), "--batch", str(TP_BATCH), "--steps", "2",
                "--dropout", "0.3", "--tensor_parallel", "2", "--dump_inputs",
                "--dump_activations", "--deterministic",
                "--save_dir", os.path.join(tmp, "cp_d")]
        # (b) alone on the card: ranks started beside others can find no
        # room for a cuDNN workspace and run another engine (F1), which
        # their refused-allocation counts would show
        t0 = time.perf_counter()
        with contextlib.chdir(tmp):             # the root is relative
            b = dp_run(2, cli("b", "f32"), os.path.join(logs, "b"),
                       backend="gloo")
        rec["b_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = dp_run(4, four, os.path.join(logs, "d"), backend="gloo")
        rec["d_seconds"] = time.perf_counter() - t0
        rec["b_refused_allocations"] = [r["refused_allocations"] for r in b]
        if any(rec["b_refused_allocations"]):
            raise AssertionError(f"tensor_parallel (b): refused allocations "
                                 f"{rec['b_refused_allocations']} (F1)")
        out_b = os.path.join(tmp, "b")
        rows = [torch.load(os.path.join(out_b, f"rank0_in{k}.pt"),
                           weights_only=True)[0] for k in range(
                               1, TP_STEPS + 1)]
        rec["b"] = {"ranks_byte_equal": dp_bytes(out_b, 0) == dp_bytes(
            out_b, 1), "rows_digest": hashlib.sha256(b"".join(
                r.contiguous().numpy().tobytes() for r in rows)).hexdigest(
                )[:16], "launches_a_step": [
            {k: v / TP_STEPS for k, v in r["launches"].items()} for r in b],
            "model_group_sums": [r["tp_sums"] for r in b]}
        rec["b_metrics"] = b[0]["metrics"]
        if not rec["b"]["ranks_byte_equal"] or len(b[0]["metrics"]) != (
                TP_STEPS):
            raise AssertionError(f"tensor_parallel (b): {rec['b']}")
        want = {"adain": 6, "upsample": 6, "bottleneck": 58}
        for r in b:
            for k in ("adain", "upsample", "bottleneck"):
                launch_totals[k] += r["launches"][k]
            if {k: r["launches"][k] / TP_STEPS for k in want} != want:
                raise AssertionError(f"tensor_parallel (b) launches "
                                     f"{r['launches']}")
        out_d = os.path.join(tmp, "d")
        rows = [torch.load(os.path.join(out_d, f"rank{r}_in1.pt"),
                           weights_only=True) for r in range(4)]
        acts = [torch.load(os.path.join(out_d, f"rank{r}_act.pt"),
                           weights_only=True) for r in range(4)]
        rec["d"] = {
            "rows_equal_in_a_data_row": all(
                torch.equal(x_, y_) for a, b_ in ((0, 1), (2, 3))
                for x_, y_ in zip(rows[a], rows[b_])),
            "rows_differ_across_data_rows": not torch.equal(rows[0][0],
                                                            rows[2][0]),
            "masks_equal_in_a_data_row": torch.equal(acts[0], acts[1])
            and torch.equal(acts[2], acts[3]),
            "masks_differ_across_data_rows": not torch.equal(
                acts[0] == 0, acts[2] == 0),
            "ranks_byte_equal": len({dp_bytes(out_d, r) for r in range(4)})
            == 1,
            "launches": [r["launches"] for r in d]}
        for r in d:
            for k in ("adain", "upsample", "bottleneck"):
                launch_totals[k] += r["launches"][k]
        if not all(v for k, v in rec["d"].items() if k != "launches"):
            raise AssertionError(f"tensor_parallel (d): {rec['d']}")
        t0 = time.perf_counter()
        parity_child("tp_step_parity", (tmp, est_path, out_b), tmp, rec,
                     ("b_parity", "c_parity", "c_bit_equal_on_load",
                      "b_refused_allocations_in_reference",
                      "f1_fresh_process"))
        rec["b_c_parity_seconds"] = time.perf_counter() - t0
        # F1: the reference step 1 again in this process, after every
        # earlier phase, bit-equal to the fresh process's unless the card
        # refused an allocation (then another cuDNN engine ran)
        free_cuda()
        rec["f1_this_process"] = f1_step_digest(
            os.path.join(tmp, "tp_init.pt"), est_path, out_b)
        here, fresh = rec["f1_this_process"], rec["f1_fresh_process"]
        if (here["digest"] != fresh["digest"]
                and not (here["refused_allocations"]
                         or fresh["refused_allocations"])):
            raise AssertionError(f"F1: the f32 reference step differs "
                                 f"between processes with no allocation "
                                 f"refused: {here} != {fresh}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec.pop("b_metrics", None)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


# ------------------------------------------------------------------ spatial
SP_SIZE, SP_BATCH = 256, 16       # (a): the serving forward's shape
SP_UNEVEN = 224                   # (a) at degree 4: rows 48/64/48/64
SP_GAN_SIZE, SP_GAN_BATCH, SP_STEPS = 224, 8, 3   # (b): the est trainer's
# K1's split form and K2's row window at shard 0 of a 256x256, B=16
# forward at degree 2 (rows 0-127): the decoder's AdaIN and upsample
# inputs, once each a forward (the kernels line times these)
SPLIT_SITES = {"adain3": (16, 512, 16, 32), "adain2": (16, 256, 32, 64),
               "adain1": (16, 128, 64, 128)}
SPLIT_NAMES = ("adain_split", "upsample_rows")


def split_counts(k1, k2, zero=False):
    """The split forms' launch counts (K1's two launches, K2's row
    window); with ``zero`` set them to 0 first."""
    attrs = ((k1, "stats_launches"), (k1, "apply_launches"),
             (k2, "rows_launches"))
    if zero:
        for m, a in attrs:
            setattr(m, a, 0)
    return {a: getattr(m, a) for m, a in attrs}


def shard_shapes():
    """Every shard's decoder AdaIN / upsample input (b, c, h, w) on the
    spatial paths, with its window (n_in, start): phase (a)'s 256² at
    degrees 2 and 4 and 224² at degree 4, (b)'s 224² at degree 2."""
    from weather_unet_tpu_torch.parallel.mesh import row_cut

    out = []
    for size, n, b in ((SP_SIZE, 2, SP_BATCH), (SP_SIZE, 4, SP_BATCH),
                       (SP_UNEVEN, 4, SP_BATCH),
                       (SP_GAN_SIZE, 2, SP_GAN_BATCH)):
        for f, c in ((8, 512), (4, 256), (2, 128)):
            for start, rows in row_cut(size, n):
                shape = (b, c, rows // f, size // f)
                out.append((f"{size}/{n} rows {start // f}+{rows // f}",
                            shape, (size // f, start // f)))
    return out


def stats_errs(stats, ref):
    """K1's split statistics against their plain version, each channel at
    its own scale: the mean's largest error over max(1, max |mean|), and
    M2's largest error relative to its own plane's M2."""
    mean, ref_mean = stats[..., 0], ref[..., 0]
    m2, ref_m2 = stats[..., 1], ref[..., 1]
    return (max_err(mean, ref_mean) / max(1.0, float(ref_mean.abs().max())),
            float(((m2 - ref_m2).abs() / ref_m2.abs().clamp_min(
                torch.finfo(torch.float32).tiny)).max()))


def window_grid(slab, n_in, start):
    """``F.grid_sample``'s grid (align_corners=True) for the output rows
    ``[2 start, 2 (start + h))`` of an image of ``n_in`` rows from
    ``slab`` (B, C, h + 2, W), its rows ``[start - 1, start + h + 1)``:
    each output row's source row on the whole image's 2x align-corners
    grid, offset to the slab, and each output column's on the row's."""
    b, _, hs, w = slab.shape
    o = np.arange(2 * start, 2 * (start + hs - 2), dtype=np.float64)
    gy = 2 * (o * (n_in - 1) / (2 * n_in - 1) - (start - 1)) / (hs - 1) - 1
    gx = 2 * np.arange(2 * w, dtype=np.float64) / (2 * w - 1) - 1
    grid = np.stack(np.broadcast_arrays(gx[None, :], gy[:, None]), -1)
    return torch.from_numpy(grid.astype(np.float32)).to(
        slab.device, slab.dtype).expand(b, -1, -1, -1).contiguous()


def bits(t):
    return t.contiguous().view(torch.int32)


def split_records(k1, k2, dt, site, shape, window, timed, failures):
    """K1's split form and K2's row window at one shard shape against their
    plain versions (ops/norm.py::plane_stats, each channel at its own
    scale; the apply kernel's merge of this shard's statistics and a
    second shard's, the same, bit for bit against merge_plane_stats, and
    its output against adain_from_stats with that merge and
    adain_from_shard_stats of the plain statistics;
    ops/resize.py::upsample_x2_rows); with ``timed`` their ms, plain ms,
    bound and library ms (K2's: ``F.grid_sample`` on the slab with the
    window's grid) and K1's pair under torch.profiler: each of its two
    kernels' device ms, the exchange's stand-in's (``torch.stack`` of the
    shards' statistics), and its device kernels a call, which must be
    those three."""
    import torch.nn.functional as F

    from weather_unet_tpu_torch.ops.norm import (
        adain_from_shard_stats, adain_from_stats, merge_plane_stats,
        plane_stats)
    from weather_unet_tpu_torch.ops.resize import upsample_x2_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    b, c, h, w = shape
    x = (torch.randn(b, c, h, w, generator=gen, device="cuda") * 2
         + 0.5).to(dt)
    y = torch.randn(b, 4 * c, generator=gen, device="cuda").to(dt)
    stats = k1.adain_stats_kernel(x)
    ref_stats = plane_stats(x)
    # this shard beside a second shard of the same values, stacked as the
    # exchange stacks them
    counts = [h * w] * 2
    shards = torch.stack([stats, stats])
    out, merged = k1.adain_apply_kernel(x, y, shards, counts, 1e-5,
                                        merged=True)
    want = merge_plane_stats(shards, counts)
    ref = adain_from_stats(x, y, want, 1e-5)
    plain = adain_from_shard_stats(x, y, torch.stack([ref_stats] * 2),
                                   counts, 1e-5)
    name = f"adain_split {site} {DT_NAME[dt]}"
    mean_err, m2_err = stats_errs(stats, ref_stats)
    for what, e in (("mean", mean_err), ("M2", m2_err)):
        if not e <= TOL_REL[torch.float32]:
            failures.append(f"{name} stats: {what} relative err {e} > "
                            f"tol {TOL_REL[torch.float32]}")
    merge_equal = torch.equal(bits(merged), bits(want))
    if not merge_equal:
        failures.append(f"{name}: the kernel's merged statistics differ "
                        f"from merge_plane_stats")
    err = max_err(out, ref)
    tol = check(name, err, ref, dt, failures)
    plain_err = max_err(out, plain)
    check(name + " on plain statistics", plain_err, plain, dt, failures)
    a = {"phase": "spatial_kernel", "kernel": "adain_split", "site": site,
         "dtype": DT_NAME[dt], "shape": list(shape), "max_abs_err": max(
             err, plain_err), "apply_max_abs_err": err,
         "plain_stats_max_abs_err": plain_err,
         "stats_mean_rel_err": mean_err, "stats_m2_rel_err": m2_err,
         "merge_bit_equal": merge_equal, "tol": tol}
    n_in, start = window
    slab = torch.randn(b, c, h + 2, w, generator=gen, device="cuda").to(dt)
    if start == 0:
        slab[:, :, 0] = 0
    if start + h == n_in:
        slab[:, :, -1] = 0
    up = k2.upsample_rows_kernel(slab, n_in, start)
    uref = upsample_x2_rows(slab, n_in, start)
    uerr = max_err(up, uref)
    utol = check(f"upsample_rows {site} {DT_NAME[dt]}", uerr, uref, dt,
                 failures)
    u = {"phase": "spatial_kernel", "kernel": "upsample_rows", "site": site,
         "dtype": DT_NAME[dt], "shape": list(slab.shape), "window": window,
         "plan": k2.plan_upsample(b, c, h, w, dt, window=window)["name"],
         "max_abs_err": uerr, "tol": utol}
    if timed:
        def pair():
            st = k1.adain_stats_kernel(x)
            return k1.adain_apply_kernel(x, y, torch.stack([st] * 2), counts,
                                         1e-5)

        def plain_pair():
            st = plane_stats(x)
            return adain_from_shard_stats(x, y, torch.stack([st] * 2),
                                          counts, 1e-5)

        a["ms"] = time_ms(pair)
        a.update(pair_profile(pair, name, failures))
        a["cold_l2_ms"] = None
        a["plain_ms"] = time_ms(plain_pair)
        # stats: x read, (mean, M2) written; apply: x, y_proj and the n
        # shards' statistics read, out written
        a["bound_ms"], a["bound_by"] = bound(
            2 * nbytes(x) + (1 + len(counts)) * nbytes(stats)
            + nbytes(y, out), 6.0 * x.numel(), dt)
        a["library_ms"] = None
        emit({"phase": "spatial_stand_in", "site": site,
              "dtype": DT_NAME[dt], "what": "torch.stack of the shards' "
              "statistics, the exchange's stand-in between K1's two "
              "launches", "device_ms": a["stand_in_device_ms"]})
        u["ms"] = time_ms(lambda: k2.upsample_rows_kernel(slab, n_in, start))
        u["device_ms"] = u["launch_only_ms"] = device_ms(
            lambda: k2.upsample_rows_kernel(slab, n_in, start))
        u["cold_l2_ms"] = None
        u["plain_ms"] = time_ms(lambda: upsample_x2_rows(slab, n_in, start))
        u["bound_ms"], u["bound_by"] = bound(nbytes(slab, up),
                                             8.0 * up.numel(), dt)
        grid = window_grid(slab, n_in, start)        # built once, untimed

        def library():
            return F.grid_sample(slab, grid, mode="bilinear",
                                 align_corners=True)

        # grid_sample takes its grid in the slab's dtype: in float32 it
        # computes the window to the coordinates' rounding; a bfloat16 grid
        # misplaces the taps, so no call computes the bfloat16 window
        try:
            u["library_max_abs_err"] = max_err(library(), uref)
        except RuntimeError as e:        # no grid_sample kernel for dt
            if "BFloat16" not in str(e):
                raise
            u["library_note"] = str(e)[:200]
        u["library_ms"] = (time_ms(library) if dt == torch.float32
                           else None)
    return a, u


K1_MODE = re.compile(r"adain_kernel<[^>]*,\s*(\d)>")   # csrc/adain.cu Mode
PAIR_KERNELS = {"1": "wut_adain_stats", "2": "wut_adain_apply"}


def pair_profile(pair, name, failures, reps: int = 10) -> dict:
    """K1's split pair under torch.profiler: the device ms of its stats and
    apply kernels (by the kernel template's mode), of everything else (the
    exchange's stand-in), and the device kernels a call, which must be the
    two K1 launches and the stand-in, one each."""
    for _ in range(2):                       # warm-up
        pair()
    calls = per_call(kernel_records(pair, reps), reps)
    by_kernel, other, n_other = {}, 0.0, 0
    for kname, (ms, n) in calls.items():
        m = K1_MODE.search(kname)
        if m and m.group(1) in PAIR_KERNELS:
            key = PAIR_KERNELS[m.group(1)]
            by_kernel[key] = by_kernel.get(key, 0.0) + ms
            if n != 1:
                failures.append(f"{name}: {key} {n} launches a call")
        else:
            other += ms
            n_other += n
    count = sum(n for _, n in calls.values())
    if sorted(by_kernel) != sorted(PAIR_KERNELS.values()) or count != 3:
        failures.append(f"{name}: the pair ran {count} device kernels a "
                        f"call ({sorted(calls)}), expected wut_adain_stats, "
                        f"the stand-in and wut_adain_apply")
    device = sum(by_kernel.values()) if len(by_kernel) == 2 else None
    return {"device_ms": device, "launch_only_ms": device,
            "device_ms_by_kernel": by_kernel, "stand_in_device_ms": other,
            "stand_in_kernels_a_call": n_other,
            "device_kernels_a_call": count}


MERGE_SHAPE = (16, 256, 67, 64)    # adain2's planes, 67 rows: uneven cuts
MERGE_SHARDS = (2, 3, 4, 14)


def merge_records(k1, rec, failures):
    """The apply kernel's merge of n = 2, 3, 4 and 14 shards' statistics
    (uneven rows of a 67-row plane, each shard's from the stats kernel),
    under every plan, float32 and bfloat16: bit for bit merge_plane_stats
    on the card, and its output at the dtype's bar against
    adain_from_stats with that merge."""
    from weather_unet_tpu_torch.ops.norm import (
        adain_from_stats, merge_plane_stats)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    b, c, h, w = MERGE_SHAPE
    out = {}
    for dt in DTYPES:
        x = (torch.randn(b, c, h, w, generator=gen, device="cuda") * 2
             + 0.5).to(dt)
        y = torch.randn(b, 4 * c, generator=gen, device="cuda").to(dt)
        for n in MERGE_SHARDS:
            rows = [h // n + (k < h % n) for k in range(n)]
            starts = np.cumsum([0] + rows[:-1])
            parts = [x[:, :, s:s + r].contiguous()
                     for s, r in zip(starts, rows)]
            counts = [r * w for r in rows]
            shards = torch.stack([k1.adain_stats_kernel(p) for p in parts])
            want = merge_plane_stats(shards, counts)
            ref = adain_from_stats(parts[0], y, want, 1e-5)
            key = f"{DT_NAME[dt]} n={n}"
            r = {"rows": rows, "plans": 0, "bit_equal": True, "err": 0.0}
            for plan in k1.adain_plans(b, c, rows[0], w, dt):
                got, merged = k1.adain_apply_kernel(
                    parts[0], y, shards, counts, 1e-5, plan, merged=True)
                r["plans"] += 1
                if not torch.equal(bits(merged), bits(want)):
                    r["bit_equal"] = False
                    failures.append(f"merge {key} {plan['name']}: merged "
                                    f"statistics differ from "
                                    f"merge_plane_stats")
                e = max_err(got, ref)
                r["err"] = max(r["err"], e)
                r["tol"] = check(f"merge {key} {plan['name']}", e, ref, dt,
                                 failures)
            out[key] = r
    rec["merge"] = out


def sp_kernels(k1, k2, rec):
    """K1's split form and K2's row window at every shard shape of the
    phase in float32 and bfloat16 against their plain versions; the three
    SPLIT_SITES timed.  Returns the summary the kernels line reads."""
    failures, summary = [], {n: {} for n in SPLIT_NAMES}
    timed_shapes = {shape: site for site, shape in SPLIT_SITES.items()}
    worst = {}
    for dt in DTYPES:
        for site, shape, window in shard_shapes():
            tsite = timed_shapes.get(shape) if window[1] == 0 else None
            a, u = split_records(k1, k2, dt, site, shape, window,
                                 tsite is not None, failures)
            for r in (a, u):
                key = (r["kernel"], DT_NAME[dt])
                worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
                if tsite is not None:
                    emit(r)
                    summary[r["kernel"]].setdefault(dt, {})[tsite] = r
    merge_records(k1, rec, failures)
    rec["kernel_max_abs_err"] = {f"{k} {d}": v for (k, d), v in
                                 worst.items()}
    rec["kernel_shapes_checked"] = len(shard_shapes())
    if failures:
        raise AssertionError("spatial kernels: " + "; ".join(failures))
    return summary


def sp_serving(cunet_path, counters, split_totals, rec):
    """(a) the use_pallas cUNet split by height over cuda:0 named 2 and 4
    times (ThreadShards) at 256², B=16, float32 (TF32 off) and bfloat16,
    and 224² at degree 4 (rows 48/64/48/64) in float32."""
    from weather_unet_tpu_torch.cli.common import load_transfer
    from weather_unet_tpu_torch.parallel import spatial
    from weather_unet_tpu_torch.parallel.mesh import (
        make_mesh, put_host_local)

    k1, k2 = counters["adain"], counters["upsample"]
    rng = np.random.default_rng(SEED + 60)
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(
        0, 5, SP_BATCH)])
    out = {}
    for size, n, dts in ((SP_SIZE, 2, DTYPES), (SP_SIZE, 4, DTYPES),
                         (SP_UNEVEN, 4, (torch.float32,))):
        x = torch.from_numpy(rng.uniform(-1, 1, (SP_BATCH, size, size, 3))
                             .astype(np.float32))
        f32 = None
        for dt in dts:
            model = load_transfer(cunet_path, dtype=dt, use_pallas=True,
                                  device="cuda")
            with torch.no_grad():
                ref = model(x.permute(0, 3, 1, 2).cuda().to(dt),
                            c.cuda().to(dt)).permute(0, 2, 3, 1)
            plan = make_mesh(["cuda:0"] * n, model=n)
            sm = spatial.SpatialModel(model, plan, size)
            parts = put_host_local(plan.spatial(input_size=size), x.to(dt))
            cd = c.to(dt)
            ex0 = sm.groups[0].exchanges
            for m in counters.values():
                m.launches = 0
            split_counts(k1, k2, zero=True)
            outs = sm(parts, cd)
            torch.cuda.synchronize()
            launches = {k: m.launches for k, m in counters.items()}
            split = split_counts(k1, k2)
            split_totals["adain_split"] += (split["stats_launches"]
                                            + split["apply_launches"])
            split_totals["upsample_rows"] += split["rows_launches"]
            got = sm.join(outs)
            r = {"rows": [p.shape[1] for p in parts],
                 "split_launches": split, "launches": launches,
                 "exchanges_a_forward": sm.groups[0].exchanges - ex0,
                 "ms_split": wall_ms(lambda: sm(parts, cd)),
                 "ms_unsharded": wall_ms(lambda: model(
                     x.permute(0, 3, 1, 2).cuda().to(dt), c.cuda().to(dt)))}
            want = {k: 3 * n for k in split}
            if dt == torch.float32:
                f32 = got.float()
                r["mae_against_unsharded"] = float(
                    (got.float() - ref.float()).abs().mean())
                ok = r["mae_against_unsharded"] <= 1e-5
            else:
                r["mae_against_own_float32"] = float(
                    (got.float() - f32).abs().mean())
                ok = r["mae_against_own_float32"] <= 1e-3
            key = f"{size}_degree{n}_{DT_NAME[dt]}"
            out[key] = r
            if not (ok and split == want and launches["adain"] == 0
                    and launches["upsample"] == 0
                    and r["exchanges_a_forward"] == 20):
                raise AssertionError(f"spatial (a) {key}: {r}")
            del model, sm, ref, got, outs, parts
            free_cuda()
    rec["a_serving"] = out


def sp_gan_ranks(tmp, est_path, init, name, dtype, timing=False):
    out = os.path.join(tmp, name)
    argv = ["--out", out, "--mode", "gan", "--spatial", "2", "--size",
            str(SP_GAN_SIZE), "--batch", str(SP_GAN_BATCH), "--steps",
            str(SP_STEPS), "--dropout", "0.3", "--estimator_path", est_path,
            "--route", "k4", "--dtype", dtype, "--init", init,
            "--deterministic"]
    argv += ["--timing"] if timing else ["--snapshots", "--dump_inputs"]
    return out, dp_run(2, argv, os.path.join(tmp, "logs", name),
                       backend="gloo")


def sp_step_parity(tmp, est_path, out, init, rec):
    """(b) each f32 step k of the spatial ranks against the one-process
    step (gan_step_parity) from ``init`` or rank 0's state after step
    k - 1, on the ranks' rows of step k joined and the dropout seed of
    step k."""
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    cfg = GanConfig(input_size=SP_GAN_SIZE, batch_size=SP_GAN_BATCH,
                    num_epoch=1)
    _, _, ranks = build_gan_state(cfg, 0, "cuda", use_pallas=True)

    def case(k):
        rows = [torch.load(os.path.join(out, f"rank{i}_in{k}.pt"),
                           weights_only=True) for i in range(2)]
        inputs = (torch.cat([rows[0][0], rows[1][0]], dim=2), rows[0][1],
                  torch.cat([rows[0][2], rows[1][2]], dim=2), rows[0][3])
        ckpt.restore_checkpoint(os.path.join(out, f"rank0_s{k}.pt"), ranks)
        return ("spatial (b)", None, inputs,
                gan_snapshot(ranks, rec["b_metrics"][k - 1]))

    rec["b_parity"], rec["b_refused_allocations_in_reference"] = (
        gan_step_parity("spatial (b)", cfg, estimators(
            est_path, torch.float32, "k4", {}), SP_STEPS, init, out, case))
    del ranks
    free_cuda()


def phase_spatial(cunet_path, est_path, counters, launch_totals,
                  split_totals, smi):
    """Phase spatial (module docstring, 11d).  Returns the split forms'
    summary for the kernels line."""
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    t_phase = time.perf_counter()
    rec = {"phase": "spatial", "card": smi}
    free_cuda()
    k1, k2 = counters["adain"], counters["upsample"]
    t0 = time.perf_counter()
    summary = sp_kernels(k1, k2, rec)
    rec["kernels_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp_serving(cunet_path, counters, split_totals, rec)
    rec["a_seconds"] = time.perf_counter() - t0
    emit({**rec, "phase": "spatial_serving"})
    tmp = tempfile.mkdtemp(prefix="wut_sp_")
    try:
        cfg = GanConfig(input_size=SP_GAN_SIZE, batch_size=SP_GAN_BATCH,
                        num_epoch=1)
        _, _, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
        init = os.path.join(tmp, "sp_init.pt")
        with open(init, "wb") as f:
            f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
        del state
        free_cuda()
        t0 = time.perf_counter()
        out, b = sp_gan_ranks(tmp, est_path, init, "b", "f32")
        rec["b_seconds"] = time.perf_counter() - t0
        want = {"adain_stats": 6, "adain_apply": 6, "upsample_rows": 6}
        rec["b"] = {
            "ranks_byte_equal": dp_bytes(out, 0) == dp_bytes(out, 1),
            "launches_a_step": [{k: v / SP_STEPS for k, v in
                                 {**r["launches"], **r["split_launches"]}
                                 .items()} for r in b],
            "exchanges_a_step": [r["tp_sums"] for r in b],
            "refused_allocations": [r["refused_allocations"] for r in b]}
        rec["b_metrics"] = b[0]["metrics"]
        for r in b:
            launch_totals["bottleneck"] += r["launches"]["bottleneck"]
            split_totals["adain_split"] += (r["split_launches"]["adain_stats"]
                                            + r["split_launches"][
                                                "adain_apply"])
            split_totals["upsample_rows"] += r["split_launches"][
                "upsample_rows"]
            per = {k: v / SP_STEPS for k, v in r["split_launches"].items()}
            if (per != want or r["launches"]["bottleneck"] != 58 * SP_STEPS
                    or r["launches"]["adain"] or r["launches"]["upsample"]
                    or r["refused_allocations"]):
                raise AssertionError(f"spatial (b) launches {r}")
        if not rec["b"]["ranks_byte_equal"] or len(b[0]["metrics"]) != (
                SP_STEPS):
            raise AssertionError(f"spatial (b): {rec['b']}")
        t0 = time.perf_counter()
        parity_child("sp_step_parity", (tmp, est_path, out, init), tmp, rec,
                     ("b_parity", "b_refused_allocations_in_reference"))
        rec["b_parity_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, bf = sp_gan_ranks(tmp, est_path, init, "bf16", "bf16",
                             timing=True)
        rec["b_bf16"] = {
            f"rank{r['rank']}": {
                "step_ms": float(np.median(r["step_ms"][1:])),
                "exchange_ms": float(np.median(r["tp_sum_ms"][1:])),
                "exchanges_a_step": r["tp_sums"],
                "step_ms_all": r["step_ms"],
                "exchange_ms_all": r["tp_sum_ms"],
                "split_launches": r["split_launches"],
                "launches": r["launches"]} for r in bf}
        for r in bf:
            launch_totals["bottleneck"] += r["launches"]["bottleneck"]
            split_totals["adain_split"] += (r["split_launches"]["adain_stats"]
                                            + r["split_launches"][
                                                "adain_apply"])
            split_totals["upsample_rows"] += r["split_launches"][
                "upsample_rows"]
            if not all(np.isfinite(v) for m in r["metrics"]
                       for v in m.values()):
                raise AssertionError(f"spatial bf16: {r['metrics']}")
        rec["b_bf16_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec.pop("b_metrics", None)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return summary


# ----------------------------------------------------------------------- aot
AOT_BUCKETS = (1, 4, 16)   # serving buckets graphed in phase aot
AOT_SIZE = 256             # bench.py's serving resolution
AOT_TIMED = 10             # timed GAN and supervised steps after capture
# substrings of the kernels' names as torch.profiler (CUPTI) records them:
# a CUDA-graph replay runs no Python wrapper, so the launch counters (which
# count eager launches only) cannot see it
KERNEL_NAMES = {"adain": "adain_kernel", "upsample": "upsample2x_kernel",
                "upconv": "upconv", "bottleneck": "bottleneck"}


def require(what, rec, failed):
    """Raise if ``failed`` (descriptions of the checks of ``rec`` that
    failed) is not empty: the record first, what failed last, where the
    end of the error output shows it."""
    if failed:
        raise AssertionError(f"{what}: {rec}\n{what} failed: "
                             + "; ".join(failed))


class KeptGraph(torch.cuda.CUDAGraph):
    """The CUDA graph phase aot captures (``capture_watch`` puts it in
    ``torch.cuda.CUDAGraph``'s place): it keeps its cudaGraph_t after
    instantiation, so that its kernel nodes can be listed, and it notes its
    replays while ``replayed`` is a list.  Instantiated at capture, as a
    graph that keeps nothing is.  ``watch`` (set by ``capture_watch``) is
    called at the begin and at the end of each capture."""

    replayed = None
    watch = None

    def __new__(cls, keep_graph=False):
        return super().__new__(cls, True)

    def __init__(self, keep_graph=False):
        super().__init__(keep_graph=True)

    def capture_begin(self, *args, **kwargs):
        if KeptGraph.watch is not None:
            KeptGraph.watch[0](self)
        super().capture_begin(*args, **kwargs)

    def capture_end(self):
        super().capture_end()
        self.instantiate()
        if KeptGraph.watch is not None:
            KeptGraph.watch[1](self)

    def replay(self):
        if KeptGraph.replayed is not None:
            KeptGraph.replayed.append(self)
        super().replay()


def graph_kernel_names(graph):
    """The (mangled) names of a kept graph's kernel nodes, from its DOT
    dump (``cudaGraphDebugDotPrint``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    return re.findall(r'label="\{KERNEL\s*\n\| \{ID \| [^|]*\| ([^\n]*)',
                      dot)


def replay_launches(fn, want, graph_totals, tries=10):
    """K1-K4 launches of one call of ``fn``, a call that replays CUDA
    graphs captured under ``capture_watch``, and the number of kernels it
    launches.  A replay launches every kernel node of its graph, so the
    replayed graphs' nodes, counted by kernel name, are the exact count.
    A profile of a call (torch.profiler, CUPTI) must also show each kernel
    of ``want``: a profile can lose records, or all of them, so it is taken
    again, up to ``tries`` times.  The launches join ``graph_totals``."""
    KeptGraph.replayed = []
    try:
        fn()
        torch.cuda.synchronize()
        graphs = KeptGraph.replayed
    finally:
        KeptGraph.replayed = None
    if not graphs:
        raise AssertionError("the call replayed no CUDA graph")
    names = [n for g in graphs for n in graph_kernel_names(g)]
    got = {k: sum(pat in n for n in names) for k, pat in KERNEL_NAMES.items()}
    for _ in range(tries):
        seen = device_kernels(fn)[0]
        if all(any(KERNEL_NAMES[k] in n for n in seen)
               for k, v in want.items() if v):
            break
    else:
        raise AssertionError(f"no profile of {tries} showed the kernels of "
                             f"{want} in a replay; the graph holds {got}")
    for k, n in got.items():
        graph_totals[k] += n
    return got, len(names)


@contextlib.contextmanager
def capture_watch():
    """Every CUDA-graph capture in the block, and which of the port's
    lru-cached functions (kernel plans, tap tables, interpolation matrices,
    the dropout scale) missed during one: a capture must build nothing
    anew, its warm-up runs did.  The graphs are ``KeptGraph``s.  Yields
    {"captures": [n], "built": [...]}."""
    watch = {"captures": [0], "built": []}

    def caches():
        found = {}
        for name, mod in list(sys.modules.items()):
            if name.startswith("weather_unet_tpu_torch") and mod is not None:
                for obj in vars(mod).values():
                    if callable(getattr(obj, "cache_info", None)):
                        found[id(obj)] = obj
        return list(found.values())

    def on_begin(graph):
        graph._wut_misses = [(f, f.cache_info().misses) for f in caches()]

    def on_end(graph):
        watch["captures"][0] += 1
        watch["built"] += [f.__qualname__ for f, n in graph._wut_misses
                           if f.cache_info().misses != n]

    KeptGraph.watch = (on_begin, on_end)
    plain_graph, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, KeptGraph
    try:
        yield watch
    finally:
        KeptGraph.watch = None
        torch.cuda.CUDAGraph = plain_graph


def free_cuda():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def aot_serving(tmp, smi, graph_totals):
    """The use_pallas cUNet (and once the fuse_upconv one) through
    WeatherTransfer(aot_cache=): each bucket a CUDA graph, against the
    eager WeatherTransfer; a second instance on the same directory (a
    restart) captures every bucket again and writes nothing there."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    torch.manual_seed(SEED)
    sd = ConditionalUNet(5).state_dict()
    rng = np.random.default_rng(SEED + 30)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, AOT_SIZE, AOT_SIZE, 3))
                         .astype(np.float32)).cuda()
    c = torch.eye(5, device="cuda")[torch.from_numpy(rng.integers(0, 5, 16))
                                    .cuda()]
    k12 = {"adain": 3, "upsample": 3}
    for dt in DTYPES:
        model = ConditionalUNet(5, use_pallas=True, dtype=dt)
        model.load_state_dict(sd)
        eager = WeatherTransfer(model, "cuda")
        cache_dir = os.path.join(tmp, f"serving_{DT_NAME[dt]}")
        graphed = WeatherTransfer(model, "cuda", aot_cache=cache_dir)
        rec = {"phase": "aot_serving", "dtype": DT_NAME[dt], "card": smi,
               "size": AOT_SIZE, "use_pallas": True}
        for b in AOT_BUCKETS:
            xb, cb = x[:b].to(dt), c[:b]
            t0 = time.perf_counter()
            got = graphed.translate(xb, cb)
            torch.cuda.synchronize()
            rec[f"b{b}_first_call_s"] = time.perf_counter() - t0
            want = eager.translate(xb, cb)
            rec[f"b{b}_mae_vs_eager"] = float((got.float() - want.float())
                                              .abs().mean())
            rec[f"b{b}_max_abs_diff"] = max_err(got, want)
            runs = [(w, ips_of(lambda: (graphed if w == "graph" else eager)
                               .translate(xb, cb), b))
                    for w in ("eager", "graph", "graph", "eager")]
            rec[f"b{b}_img_per_s"] = {w: [v for ww, v in runs if ww == w]
                                      for w in ("eager", "graph")}
            rec[f"b{b}_replay_launches"], rec[f"b{b}_replay_kernels"] = (
                replay_launches(lambda: graphed.translate(xb, cb), k12,
                                graph_totals))
            for what, wt in (("eager", eager), ("graph", graphed)):
                dev, n_kernels, top = step_profile(
                    lambda: wt.translate(xb, cb), top=3)
                rec[f"b{b}_{what}_device_ms"] = dev
                rec[f"b{b}_{what}_kernels"] = n_kernels
                rec[f"b{b}_{what}_top_kernels"] = top
        rec["stats"] = dict(graphed.aot.stats)
        rec["programs"] = graphed._translate._cache_size()
        again = WeatherTransfer(model, "cuda", aot_cache=cache_dir)
        t0 = time.perf_counter()
        for b in AOT_BUCKETS:
            out = again.translate(x[:b].to(dt), c[:b])
            rec[f"b{b}_restart_mae_vs_eager"] = float(
                (out.float() - eager.translate(x[:b].to(dt), c[:b]).float())
                .abs().mean())
        torch.cuda.synchronize()
        rec["restart_s"] = time.perf_counter() - t0
        rec["restart_stats"] = dict(again.aot.stats)
        rec["files_written"] = (sorted(os.listdir(cache_dir))
                                if os.path.exists(cache_dir) else [])
        emit(rec)
        failed = [f"b{b}_{key} {rec[f'b{b}_{key}']}" for b in AOT_BUCKETS
                  for key in ("mae_vs_eager", "restart_mae_vs_eager")
                  if not rec[f"b{b}_{key}"] <= 1e-5]
        failed += [f"b{b}_replay_launches {rec[f'b{b}_replay_launches']}"
                   for b in AOT_BUCKETS if rec[f"b{b}_replay_launches"] != {
                       "adain": 3, "upsample": 3, "upconv": 0,
                       "bottleneck": 0}]
        if rec["stats"]["captures"] != 3 or rec["programs"] != 3:
            failed.append(f"captures {rec['stats']['captures']}, programs "
                          f"{rec['programs']}")
        if (rec["restart_stats"]["programs"],
                rec["restart_stats"]["captures"]) != (3, 3):
            failed.append(f"restart_stats {rec['restart_stats']}")
        if rec["files_written"]:
            failed.append(f"files written {rec['files_written']}")
        require(f"aot serving {DT_NAME[dt]}", rec, failed)
        del eager, graphed, again, model
        free_cuda()
    # the fused decoder (K3) once, bf16, B=16
    model = ConditionalUNet(5, fuse_upconv=True, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    eager = WeatherTransfer(model, "cuda")
    graphed = WeatherTransfer(model, "cuda",
                              aot_cache=os.path.join(tmp, "serving_k3"))
    xb = x.to(torch.bfloat16)
    got = graphed.translate(xb, c)
    want = eager.translate(xb, c)
    rec = {"phase": "aot_serving_fuse_upconv", "dtype": "bfloat16",
           "card": smi, "batch": 16, "size": AOT_SIZE,
           "mae_vs_eager": float((got.float() - want.float()).abs().mean()),
           "max_abs_diff": max_err(got, want),
           "img_per_s": {"eager": ips_of(lambda: eager.translate(xb, c), 16),
                         "graph": ips_of(lambda: graphed.translate(xb, c),
                                         16)}}
    rec["replay_launches"], rec["replay_kernels"] = replay_launches(
        lambda: graphed.translate(xb, c), {"upconv": 3}, graph_totals)
    emit(rec)
    if not (rec["mae_vs_eager"] <= 1e-5 and rec["replay_launches"] == {
            "adain": 0, "upsample": 0, "upconv": 3, "bottleneck": 0}):
        raise AssertionError(f"aot fuse_upconv: {rec}")
    del eager, graphed, model
    free_cuda()


SERVER_START_CHILD = r"""
import contextlib, io, json, sys, time
from weather_unet_tpu_torch.cli import serve
cache_dir, order, argv = sys.argv[1], sys.argv[2].split(","), sys.argv[3:]
def start(extra):
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        server = serve.build_server(serve.build_parser().parse_args(
            argv + extra))
    seconds = time.perf_counter() - t0
    aot = server.transfer.aot
    server.server_close()
    return seconds, None if aot is None else dict(aot.stats)
start([])     # the process's first CUDA, cuDNN and cuBLAS uses, untimed
import torch
out = {"free_gib": torch.cuda.mem_get_info()[0] / 2**30}
for what in order:
    out[what], out[what + "_stats"] = start(
        ["--aot_cache", cache_dir] if what == "tier" else [])
out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0)
print(json.dumps(out))
"""
START_BAR_S = 0.3         # a restarted tiered server against a plain one


def server_starts(cache_dir, argv, pairs):
    """Server start-ups (``build_server``: load, a warm-up of every bucket,
    with the tier its captures) as a restarted server makes them: each in
    a young process, after one untimed plain start that pays the process's
    first uses of the CUDA libraries, so every tiered start holds the
    process's first captures.  ``pairs`` times two child processes, one
    timing a plain start and then a tiered one, the other the reverse, so
    that each kind is timed as often second as third.  Returns the plain
    and the tiered seconds, the tier's counters, and the difference of the
    medians."""
    out = {"plain": [], "tier": [], "order": []}
    for i in range(2 * pairs):
        order = ("plain", "tier") if i % 2 == 0 else ("tier", "plain")
        proc = subprocess.run(
            [sys.executable, "-c", SERVER_START_CHILD,
             f"{cache_dir}_{i}", ",".join(order), *argv],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"server start child: rc {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for what in order:
            out[what].append(got[what])
        out["order"].append(",".join(order))
        for k in ("free_gib", "alloc_retries"):
            out.setdefault(k, []).append(got[k])
        out["tier_stats"] = got["tier_stats"]
    out["tier_minus_plain_s"] = float(np.median(out["tier"])
                                      - np.median(out["plain"]))
    return out


def aot_server_starts(smi, pairs=1):
    """Phase aot's server restarts, run right after the build, while this
    process holds nothing on the card, as a restarted server's host does:
    ``server_starts`` of serve --aot_cache against a plain server (bf16,
    224x224, max_batch 16, a seeded random cUNet), ``pairs`` pairs of
    young processes.  The tier's median within START_BAR_S of the plain
    one's, five captures a tiered start, no file written."""
    from weather_unet_tpu_torch.cli import serve
    from weather_unet_tpu_torch.models import ConditionalUNet

    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(SEED + 31)
        pt = os.path.join(tmp, "server_cunet.pt")
        torch.save({"inference": ConditionalUNet(5).state_dict()}, pt)
        cache_dir = os.path.join(tmp, "aot")
        got = server_starts(cache_dir, [
            "--cp_path", pt, "--host", "127.0.0.1", "--port", "0",
            "--input_size", "224", "--max_batch", "16", "--bf16"], pairs)
        wrote = sorted(n for n in os.listdir(tmp) if n.startswith("aot"))
    rec = {"phase": "aot_server_starts", "card": smi, "dtype": "bfloat16",
           "size": 224, "max_batch": 16, **got, "wrote": wrote}
    emit(rec)
    n_buckets = len(serve.warmup_buckets(16))
    failed = []
    if not rec["tier_minus_plain_s"] <= START_BAR_S:
        failed.append(f"tier restarts {rec['tier']} s against plain ones' "
                      f"{rec['plain']} s")
    if (rec["tier_stats"]["programs"],
            rec["tier_stats"]["captures"]) != (n_buckets, n_buckets):
        failed.append(f"tier stats {rec['tier_stats']}")
    if wrote:
        failed.append(f"the tier wrote {wrote}")
    require("aot server starts", rec, failed)


def aot_server(tmp, smi):
    """serve --aot_cache (bf16, 224x224, max_batch 16) against a server
    without the tier: start-up seconds of each in this process, for the
    record (``aot_server_starts`` holds a restart's), and no file written;
    then the same 96 POSTs of the i2w world's photos from 8 clients, in
    turns (plain, tier, tier, plain)."""
    import urllib.request

    from weather_unet_tpu_torch.cli import serve
    from weather_unet_tpu_torch.models import ConditionalUNet

    from weather_unet_tpu_torch.testing import build_i2w_world

    torch.manual_seed(SEED + 31)
    pt = os.path.join(tmp, "server_cunet.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict()}, pt)
    # the request bodies: the i2w world the port's tests build (testing.py),
    # 5 classes x 4 seeded 256x256 photos
    world = build_i2w_world(os.path.join(tmp, "server_world"), per_class=4,
                            size=256, rng=np.random.default_rng(SEED + 34))
    jpegs = world["paths"]["train"] + world["paths"]["test"]
    paths = [jpegs[i % len(jpegs)] for i in range(SERVE_REQUESTS)]
    queries = [f"class={i % 5}" for i in range(SERVE_REQUESTS)]
    cache_dir = os.path.join(tmp, "server_aot")
    base_args = ["--cp_path", pt, "--host", "127.0.0.1", "--port", "0",
                 "--input_size", "224", "--max_batch", "16", "--bf16"]
    rec = {"phase": "aot_server", "card": smi, "dtype": "bfloat16",
           "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
           "size": 224, "max_batch": 16}
    servers = {}
    try:
        for what, extra in (("tier_cold", ["--aot_cache", cache_dir]),
                            ("plain", []),
                            ("tier", ["--aot_cache", cache_dir])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                server = serve.build_server(serve.build_parser().parse_args(
                    base_args + extra))
            rec[f"{what}_startup_s"] = time.perf_counter() - t0
            if what == "tier_cold":
                rec["tier_cold_stats"] = dict(server.transfer.aot.stats)
                server.server_close()
                continue
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            servers[what] = (server, thread)
        rec["tier_stats"] = dict(servers["tier"][0].transfer.aot.stats)
        answers = {}
        for i, what in enumerate(("plain", "tier", "tier", "plain")):
            server = servers[what][0]
            base = f"http://127.0.0.1:{server.server_address[1]}"
            urllib.request.urlopen(f"{base}/healthz", timeout=60).close()
            ans, lat, wall = http_traffic(base, paths, queries,
                                          os.path.join(tmp, f"srv{i}"))
            answers[what] = ans
            rec.setdefault(f"{what}_requests_per_s", []).append(
                SERVE_REQUESTS / wall)
            rec.setdefault(f"{what}_client_p50_ms", []).append(
                float(np.percentile(lat, 50)))
            rec.setdefault(f"{what}_client_p90_ms", []).append(
                float(np.percentile(lat, 90)))
    finally:
        for server, thread in servers.values():
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    from PIL import Image

    steps = [float(np.abs(np.asarray(Image.open(io.BytesIO(a[2])), np.int16)
                          - np.asarray(Image.open(io.BytesIO(p[2])),
                                       np.int16)).mean())
             for a, p in zip(answers["tier"], answers["plain"])]
    rec["max_mean_step_tier_vs_plain"] = max(steps)
    ok = all(a[0] == 200 for w in answers for a in answers[w])
    emit(rec)
    n_buckets = len(serve.warmup_buckets(16))
    failed = []
    if not (ok and rec["max_mean_step_tier_vs_plain"] <= 1.0):
        failed.append("answers")
    for what in ("tier_cold", "tier"):
        st = rec[f"{what}_stats"]
        if (st["programs"], st["captures"]) != (n_buckets, n_buckets):
            failed.append(f"{what} stats {st}")
    if os.path.exists(cache_dir):
        failed.append(f"the tier wrote {os.listdir(cache_dir)}")
    require("aot server", rec, failed)
    free_cuda()


def state_tensors(state):
    """Every tensor of a GAN state in a fixed order: both networks'
    parameters and buffers and both optimizers' state, per parameter
    index (a parameter without optimizer state has none)."""
    out = {}
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        out.update({f"{net}.{k}": v for k, v in
                    ts.module.state_dict(keep_vars=True).items()})
        params = ts.optimizer.param_groups[0]["params"]
        for i, p in enumerate(params):
            for k, v in ts.optimizer.state.get(p, {}).items():
                out[f"{net}.opt.{i}.{k}"] = v
    return out


def put_state(state, src):
    """Make ``state`` hold ``src`` (a clone of another state's
    state_tensors): every tensor both have is copied in place -- what a
    restore into a graph's static tensors must do; optimizer state that
    only ``src`` has is created, and state that ``src`` lacks (an
    optimizer that had not stepped) is dropped, which only an eager
    trainer's optimizer may see."""
    with torch.no_grad():
        dst = state_tensors(state)
        for k, v in src.items():
            if k in dst:
                dst[k].copy_(v)
                continue
            net, _, i, key = k.split(".", 3)
            ts = getattr(state, net)
            p = ts.optimizer.param_groups[0]["params"][int(i)]
            ts.optimizer.state[p][key] = v.clone()
        for k in dst:
            if ".opt." in k and k not in src:
                net, _, i, _ = k.split(".", 3)
                ts = getattr(state, net)
                ts.optimizer.state.pop(
                    ts.optimizer.param_groups[0]["params"][int(i)], None)


def aot_gan(tmp, est_path, smi, graph_totals):
    """The GAN trainer with aot_cache at 224x224, batch 8, est mode, the
    use_pallas generator and load_step_estimator's estimator (K4-routed in
    bf16): bf16 step time and device busy share against the eager trainer
    in turns; float32 (TF32 off, dropout 0) graphed steps against eager ones
    at the GAN bars; dropout masks from the registered generator; fit under
    profile_dir."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator
    from weather_unet_tpu_torch.core.aot import AotCache, AotJit
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.models import ConditionalUNet
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    f32, bf = torch.float32, torch.bfloat16
    b, size = 8, 224
    rng = np.random.default_rng(SEED + 32)
    imgs = [torch.from_numpy(rng.uniform(-1, 1, (b, 3, size, size))
                             .astype(np.float32)).cuda() for _ in range(4)]
    zeros = torch.zeros(b, dtype=torch.long, device="cuda")
    ests = {dt: load_step_estimator(est_path, dtype=dt, device="cuda")
            for dt in DTYPES}

    def trainer(dt, name, tier, **kw):
        return WeatherTransferTrainer(
            GanConfig(input_size=size, batch_size=b, dtype=dt,
                      **{k: v for k, v in kw.items()
                         if k != "profile_dir"}),
            ests[dt], save_dir=os.path.join(tmp, "gan_cp"), name=name,
            log_dir=os.path.join(tmp, "gan_runs"), device="cuda",
            aot_cache=os.path.join(tmp, "gan_aot") if tier else None,
            profile_dir=kw.get("profile_dir"))

    def step(tr, k, do_g=True, scale=1.0):
        tr._step_rng.manual_seed(fold_seed(tr._base_seed, k))
        x, r = imgs[2 * (k % 2)], imgs[2 * (k % 2) + 1]
        tr.state, m = tr._step(tr.state, x * scale, zeros, r, zeros,
                               tr._step_rng, do_g=do_g)
        return m

    def timed(tr, k, do_g=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(tr, k, do_g)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, m

    # 1. bf16: eager and graphed trainers in turns, one step each a turn
    torch.cuda.reset_peak_memory_stats()
    trs = {"eager": trainer(bf, "bf_eager", False),
           "graph": trainer(bf, "bf_graph", True)}
    rec = {"phase": "aot_gan", "dtype": "bfloat16", "card": smi, "batch": b,
           "size": size, "dropout": 0.3, "estimator_route": "k4"}
    # a D-only step first, as a fresh run with GD_train_ratio 2 takes it:
    # its graph is captured before G's Adam has state, and replays below
    # after the D+G capture has made that state
    for what, tr in trs.items():
        rec[f"{what}_first_d_step_ms"] = timed(tr, 1, do_g=False)[0]
        rec[f"{what}_first_step_ms"] = timed(tr, 2)[0]
    times = {w: [] for w in trs}
    for k in range(AOT_TIMED):
        for what in (("eager", "graph") if k % 2 else ("graph", "eager")):
            ms, m = timed(trs[what], 3 + k)
            times[what].append(ms)
            if not all(np.isfinite(float(v)) for v in m.values()):
                raise AssertionError(f"aot gan {what}: metrics {m}")
    for what in trs:
        ms = float(np.median(times[what]))
        rec[f"{what}_step_ms"] = ms
        rec[f"{what}_step_ms_all"] = times[what]
        rec[f"{what}_img_per_s"] = b / ms * 1e3
        dev, n_kernels, top = step_profile(lambda: step(trs[what], 99))
        rec[f"{what}_device_ms"] = dev
        rec[f"{what}_kernels"] = n_kernels
        rec[f"{what}_busy_share"] = dev / ms
        rec[f"{what}_top_kernels"] = top
    rec["replay_launches"], rec["replay_kernels"] = replay_launches(
        lambda: step(trs["graph"], 100),
        {"adain": 6, "upsample": 6, "bottleneck": 58}, graph_totals)
    rec["replay_launches_d_only"], _ = replay_launches(
        lambda: step(trs["graph"], 101, do_g=False),
        {"adain": 3, "upsample": 3, "bottleneck": 58}, graph_totals)
    rec["stats"] = dict(trs["graph"].aot.stats)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(rec)
    if not (rec["replay_launches"] == {"adain": 6, "upsample": 6,
                                       "upconv": 0, "bottleneck": 58}
            and rec["replay_launches_d_only"] == {
                "adain": 3, "upsample": 3, "upconv": 0, "bottleneck": 58}
            and rec["stats"]["captures"] == 2):
        raise AssertionError(f"aot gan bf16: {rec}")
    del trs
    free_cuda()

    # 2. float32 (TF32 off), dropout 0: the graphed step against the eager
    #    step, twice, each from the eager trainer's state copied into the
    #    graph's tensors in place; the float32 floor from a third trainer
    trs = {w: trainer(f32, f"f32_{w}", w == "graph", dropout_rate=0.0)
           for w in ("eager", "graph", "floor")}
    lr = trs["eager"].cfg.lr
    for k in (1, 2):
        pre = {n: v.detach().clone()
               for n, v in state_tensors(trs["eager"].state).items()}
        put_state(trs["graph"].state, pre)
        want = gan_snapshot(trs["eager"].state, step(trs["eager"], k))
        got = gan_snapshot(trs["graph"].state, step(trs["graph"], k))

        def floor_run(scale):
            put_state(trs["floor"].state, pre)
            return gan_snapshot(trs["floor"].state,
                                step(trs["floor"], k, scale=scale))

        errs = [snapshot_errs(floor_run(1 + s * ONE_ROUNDING), want)
                for s in (1, -1)]
        floor = {key: max(e[key] for e in errs) for key in MOMENT_KEYS}
        # Adam's k-th update reaches sqrt(k) * lr where the earlier
        # gradients were ~0 (bias correction), so the sign-flip bound of
        # step k is 2.2 * lr * sqrt(k) (tests/test_torch_gan.py's
        # assert_adam_close)
        rec = gan_states_agree(got, want, lr * np.sqrt(k), GAN_TOL,
                               f"aot gan float32 step {k}", floor)
        emit({"phase": "aot_gan_parity", "dtype": "float32", "step": k,
              "card": smi, "batch": b, "size": size,
              "losses": got["losses"], **rec})
    del trs, pre
    free_cuda()

    # 3. dropout: a graphed train-mode generator forward (float32, rate
    #    0.3) draws its masks from the registered generator
    gen_model = ConditionalUNet(5, 0.3, use_pallas=True,
                                generator=torch.Generator().manual_seed(
                                    SEED)).cuda()
    forward = AotJit(
        lambda m, x, cc, g: m(x, cc, train=True, generator=g),
        AotCache(os.path.join(tmp, "dropout_aot")), inplace_argnums=(0,))
    g = torch.Generator(device="cuda")
    cond = torch.eye(5, device="cuda")[torch.arange(b, device="cuda") % 5]
    outs = {}
    with torch.no_grad():
        for seed in (1, 2, 1):
            g.manual_seed(seed)
            outs.setdefault(seed, []).append(forward(gen_model, imgs[0],
                                                     cond, g))
        g.manual_seed(1)
        eager1 = gen_model(imgs[0], cond, train=True, generator=g)
    rec = {"phase": "aot_dropout", "card": smi, "dtype": "float32",
           "rate": 0.3, "batch": b, "size": size,
           "mae_seed1_vs_seed2": float((outs[1][0] - outs[2][0]).abs()
                                       .mean()),
           "seed1_replays_equal": bool(torch.equal(outs[1][0], outs[1][1])),
           "mae_graph_vs_eager_seed1": float((outs[1][0] - eager1).abs()
                                             .mean())}
    emit(rec)
    if not (rec["seed1_replays_equal"]
            and rec["mae_graph_vs_eager_seed1"] <= 1e-5
            and rec["mae_seed1_vs_seed2"] > 100 * max(
                rec["mae_graph_vs_eager_seed1"], 1e-6)):
        raise AssertionError(f"aot dropout: {rec}")
    del gen_model, forward, outs, eager1
    free_cuda()

    # 4. fit under profile_dir with GD_train_ratio 2: D-only, D+G, D-only
    #    steps through the tier; the trace names K1, K2 and K4.  A profile
    #    can lose every device record (device_kernels), so a fit whose trace
    #    holds no kernel at all is run again, up to 3 times
    mem = [(rng.integers(0, 256, (size, size, 3), np.uint8),
            np.zeros(5, np.float32), str(i)) for i in range(6 * b)]
    for attempt in range(3):
        prof_dir = os.path.join(tmp, f"gan_profile{attempt}")
        tr = trainer(bf, f"profiled{attempt}", True, num_epoch=1,
                     gd_train_ratio=2, profile_dir=prof_dir)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tr.fit(lambda: BatchLoader(mem[:3 * b], b),
                   lambda: BatchLoader(mem[3 * b:], b, seed=1))
        rec = {"phase": "aot_profile_dir", "card": smi, "attempt": attempt,
               "fit_s": time.perf_counter() - t0,
               "steps": tr.state.global_step, "g_steps": tr.state.gen.step,
               "captures": tr.aot.stats["captures"], "trace_kernels": 0,
               "trace_launches": {k: 0 for k in KERNEL_NAMES}}
        del tr
        free_cuda()
        traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
        rec["trace_files"] = len(traces)
        if traces:
            rec["trace_mib"] = os.path.getsize(traces[0]) / 2 ** 20
            with open(traces[0]) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e.get("name", "") for e in events
                       if e.get("cat") == "kernel"]
            rec["trace_kernels"] = len(kernels)
            rec["trace_launches"] = {k: sum(pat in n for n in kernels)
                                     for k, pat in KERNEL_NAMES.items()}
        emit(rec)
        if rec["trace_files"] != 1 or rec["trace_kernels"]:
            break
    failed = [f"{k} {rec[k]}" for k, v in (("trace_files", 1), ("steps", 3),
                                           ("g_steps", 1), ("captures", 2))
              if rec[k] != v]
    failed += [f"trace_launches {rec['trace_launches']}"] if not all(
        rec["trace_launches"][k] > 0
        for k in ("adain", "upsample", "bottleneck")) else []
    require("aot profile_dir", rec, failed)


def aot_supervised(tmp, smi):
    """The supervised estimator step (ResNet-101, 224x224, B=64) as a CUDA
    graph: bf16 step time and busy share against the eager step in turns;
    one float32 (TF32 off) graphed step against the eager one; and
    train_supervised(aot_cache=) over 3 batches."""
    from weather_unet_tpu_torch.core.aot import AotCache, AotJit
    from weather_unet_tpu_torch.core.optim import set_capturable
    from weather_unet_tpu_torch.models import ResNet101
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    rng = np.random.default_rng(SEED + 33)
    x = torch.from_numpy(rng.uniform(-1, 1, (SUP_BATCH, 3, SUP_SIZE,
                                             SUP_SIZE)).astype(np.float32)
                         ).cuda()
    t = torch.from_numpy(rng.standard_normal((SUP_BATCH, 5)).astype(
        np.float32)).cuda()

    def state(dt):
        model = ResNet101(5, dtype=dt, param_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(SEED))
        return sup.build_supervised_state(model.cuda(), 1e-4, 1e-5)

    def graphed(st, name):
        set_capturable(st.optimizer, True)
        cache = AotCache(os.path.join(tmp, name))
        return sup.stepped(AotJit(sup.make_estimator_step().program, cache,
                                  inplace_argnums=(0,))), cache

    def timed(step, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, x, t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, m

    rec = {"phase": "aot_supervised", "card": smi, "dtype": "bfloat16",
           "batch": SUP_BATCH, "size": SUP_SIZE, "model": "ResNet-101"}
    torch.cuda.reset_peak_memory_stats()
    sts = {"eager": state(torch.bfloat16), "graph": state(torch.bfloat16)}
    steps = {"eager": sup.make_estimator_step()}
    steps["graph"], cache = graphed(sts["graph"], "sup_aot")
    for what in sts:
        rec[f"{what}_first_step_ms"] = timed(steps[what], sts[what])[0]
    times = {w: [] for w in sts}
    for k in range(AOT_TIMED):
        for what in (("eager", "graph") if k % 2 else ("graph", "eager")):
            ms, m = timed(steps[what], sts[what])
            times[what].append(ms)
    for what in sts:
        ms = float(np.median(times[what]))
        rec[f"{what}_step_ms"] = ms
        rec[f"{what}_img_per_s"] = SUP_BATCH / ms * 1e3
        dev, n_kernels, _ = step_profile(
            lambda: steps[what](sts[what], x, t))
        rec[f"{what}_device_ms"] = dev
        rec[f"{what}_kernels"] = n_kernels
        rec[f"{what}_busy_share"] = dev / ms
    rec["metrics"] = {k: float(v) for k, v in m.items()}
    rec["stats"] = dict(cache.stats)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del sts, steps
    free_cuda()
    # float32 (TF32 off): one graphed step against one eager step
    a, bb = state(torch.float32), state(torch.float32)
    step_g, _ = graphed(a, "sup_aot_f32")
    a, ma = step_g(a, x, t)
    bb, mb = sup.make_estimator_step()(bb, x, t)
    rec["float32_loss_rel_err"] = {
        k: abs(float(ma[k]) - float(mb[k])) / abs(float(mb[k])) for k in mb}
    sa, sb = a.module.state_dict(), bb.module.state_dict()
    rec["float32_bn_max_abs_err"] = max(
        float((sa[k].float() - sb[k].float()).abs().max()) for k in sb
        if k.endswith(("running_mean", "running_var")))
    rec["float32_params"] = sup_params_agree(a, bb, 1e-4)
    del a, bb, step_g
    free_cuda()
    # train_supervised(aot_cache=) over 3 in-memory batches
    st = state(torch.bfloat16)
    batches = [(rng.integers(0, 256, (SUP_BATCH, SUP_SIZE, SUP_SIZE, 3),
                             np.uint8),
                rng.standard_normal((SUP_BATCH, 5)).astype(np.float32))
               for _ in range(3)]
    loop_cache = AotCache(os.path.join(tmp, "sup_loop_aot"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_supervised(
            sup.make_estimator_step(), sup.make_eval_metrics("estimator"),
            lambda: batches, lambda: batches[:1], state=st, num_epoch=1,
            input_size=SUP_SIZE, save_dir=os.path.join(tmp, "sup_cp"),
            name="aot", save_per_epoch=1 << 30, aot_cache=loop_cache)
    rec["train_supervised_s"] = time.perf_counter() - t0
    rec["train_supervised_steps"] = st.step
    rec["train_supervised_stats"] = dict(loop_cache.stats)
    emit(rec)
    del st
    free_cuda()
    if not (all(v <= 1e-4 for v in rec["float32_loss_rel_err"].values())
            and rec["float32_bn_max_abs_err"] <= 1e-5
            and rec["float32_params"]["ok"]
            and rec["stats"]["captures"] == 1
            and rec["train_supervised_steps"] == 3
            and rec["train_supervised_stats"]["captures"] == 1
            and all(np.isfinite(v) for v in rec["metrics"].values())):
        raise AssertionError(f"aot supervised: {rec}")


def aot_doctor(smi):
    """The doctor's ``main(["--json", "--probe"])`` returns 0 and names
    the card (in this process: a depth cut, CUTS)."""
    from weather_unet_tpu_torch.cli import doctor

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = doctor.main(["--json", "--probe"])
    info = json.loads(out.getvalue()) if rc == 0 else {}
    rec = {"phase": "aot_doctor", "card": smi, "rc": rc,
           "seconds": time.perf_counter() - t0,
           "devices": info.get("devices"), "nvcc": info.get("nvcc"),
           "kernels_built": info.get("kernels", {}).get("built"),
           "native_runtime": info.get("native_runtime"),
           "probe_first_call_s": info.get("probe_first_call_s"),
           "probe_roundtrip_ms": info.get("probe_roundtrip_ms")}
    emit(rec)
    if not (rc == 0 and info["devices"][0]["name"]
            == torch.cuda.get_device_name(0)):
        raise AssertionError(f"doctor: rc {rc}: {err.getvalue()}")


def phase_aot(est_path, smi, graph_totals):
    """Phase aot: the AOT tier (core/aot.py) on the card at full width --
    serving buckets, serve --aot_cache, the GAN trainer and the supervised
    step as CUDA graphs, held to their eager counterparts; every capture
    builds nothing anew; the doctor."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, capture_watch() as watch:
        aot_serving(tmp, smi, graph_totals)
        aot_server(tmp, smi)
        aot_gan(tmp, est_path, smi, graph_totals)
        aot_supervised(tmp, smi)
    aot_doctor(smi)
    emit({"phase": "aot_done", "seconds": time.perf_counter() - t_phase,
          "captures": watch["captures"][0],
          "built_during_capture": watch["built"]})
    if watch["built"]:
        raise AssertionError(f"a capture built {watch['built']} anew")


# ------------------------------------------------------------ dynamics

DYN_ARGS = ["--size", "64", "--batch", "32", "--steps", "120",
            "--report_every", "40", "--dtype", "bfloat16"]
PART_REL = 1e-3           # the step where two runs' losses part


def load_demo():
    """examples/synthetic_weather_demo_torch.py as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "synthetic_weather_demo_torch.py")
    spec = importlib.util.spec_from_file_location("wut_demo_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def replayed_kernels(graphs):
    """K1-K4 launches of a list of replayed KeptGraphs (a graph once for
    each replay), counted by kernel name in each graph's nodes."""
    per_graph = {}
    for g in graphs:
        if id(g) not in per_graph:
            names = graph_kernel_names(g)
            per_graph[id(g)] = {k: sum(pat in n for n in names)
                                for k, pat in KERNEL_NAMES.items()}
    got = {k: 0 for k in KERNEL_NAMES}
    for g in graphs:
        for k, n in per_graph[id(g)].items():
            got[k] += n
    return got


def learned(run):
    """The G-learns bars of tests/test_training_dynamics.py on a demo run:
    readback below 0.60 of the untrained G's and below 0.45 of the
    no-transfer baseline, reconstruction L1 below 0.5, all finite."""
    err, recon = run["final"]["readback"], run["final"]["recon_l1"]
    return (np.isfinite(err) and np.isfinite(recon)
            and err < 0.60 * run["start_err"] and err < 0.45 * run["base_err"]
            and recon < 0.5 and np.isfinite(run["losses"]).all())


@contextlib.contextmanager
def smi_samples(every_ms=250):
    """The card's SM clock (MHz), power draw (W) and utilization (%) from
    nvidia-smi every ``every_ms`` while the block runs; yields a dict that
    holds each one's minimum and maximum once the block ends."""
    fields = ("clocks.sm", "power.draw", "utilization.gpu")
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits", "-lms", str(every_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out = {}
    try:
        yield out
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
        rows = [[float(v) for v in line.split(",")]
                for line in text.strip().splitlines()
                if line.count(",") == len(fields) - 1]
        for name, col in zip(("sm_mhz", "power_w", "util_pct"),
                             zip(*rows) if rows else ((),) * len(fields)):
            out[name] = [min(col), max(col)] if col else None
        out["samples"] = len(rows)


def window_rates(reports, batch):
    """img/s of each report window, from the demo's rates over the steps
    so far: a window's steps over the time it added."""
    out, done, elapsed = [], 0, 0.0
    for r in reports:
        until = r["step"] * batch / r["img_per_s"]
        out.append((r["step"] - done) * batch / (until - elapsed))
        done, elapsed = r["step"], until
    return out


def phase_dynamics(counters, launch_totals, smi):
    """Sub-phase dynamics: the synthetic weather demo (the port's GAN step,
    the use_pallas generator: K1 and K2) at 64x64, batch 32, bfloat16, 120
    steps, eager and with aot_cache (the step a CUDA graph): both must
    pass the G-learns bars; per run the readback at each report, img/s,
    and the first step at which the two runs' d_loss or g_loss part by
    more than 1e-3 relative."""
    demo = load_demo()
    runs, rec = {}, {"phase": "dynamics", "card": smi, "args": DYN_ARGS}
    for what in ("eager", "graph"):
        for m in counters.values():
            m.launches = 0
        with tempfile.TemporaryDirectory() as tmp, \
                capture_watch() as watch:
            argv = DYN_ARGS + ["--device", "cuda"] + (
                ["--aot_cache", os.path.join(tmp, "aot")]
                if what == "graph" else [])
            KeptGraph.replayed = []
            try:
                with smi_samples() as card:
                    t0 = time.perf_counter()
                    runs[what] = demo.run(argv, log=lambda _: None)
                    torch.cuda.synchronize()
                    rec[f"{what}_s"] = time.perf_counter() - t0
                replayed = KeptGraph.replayed
            finally:
                KeptGraph.replayed = None
            rec[f"{what}_card"] = card
            rec[f"{what}_replay_launches"] = (
                replayed_kernels(replayed) if replayed else None)
            rec[f"{what}_captures"] = watch["captures"][0]
            rec[f"{what}_built_during_capture"] = watch["built"]
        got = {k: m.launches for k, m in counters.items()}
        for k in counters:
            launch_totals[k] += got[k]
        run = runs[what]
        rec[f"{what}_launches"] = got
        rec[f"{what}_baseline"] = run["base_err"]
        rec[f"{what}_untrained_readback"] = run["start_err"]
        rec[f"{what}_reports"] = [
            {k: r[k] for k in ("step", "readback", "recon_l1", "d_loss",
                               "img_per_s")} for r in run["reports"]]
        rec[f"{what}_final"] = run["final"]
        rec[f"{what}_img_per_s"] = run["reports"][-1]["img_per_s"]
        # the first window holds the graphed run's capture
        rec[f"{what}_window_img_per_s"] = window_rates(
            run["reports"], int(DYN_ARGS[DYN_ARGS.index("--batch") + 1]))
        rec[f"{what}_aot"] = run["aot"]
        rec[f"{what}_learned"] = bool(learned(run))
    a, b = runs["eager"]["losses"], runs["graph"]["losses"]
    rel = np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                     1e-30)
    parted = np.nonzero((rel > PART_REL).any(axis=1))[0]
    rec["first_parting_step"] = int(parted[0]) + 1 if len(parted) else None
    rec["losses_rel_diff_max"] = float(rel.max())
    emit(rec)
    steps = int(DYN_ARGS[DYN_ARGS.index("--steps") + 1])
    failed = [f"{w} did not learn" for w in runs if not rec[f"{w}_learned"]]
    failed += [f"{w} launches {rec[f'{w}_launches']}" for w in runs
               if not (rec[f"{w}_launches"]["adain"] >= 3
                       and rec[f"{w}_launches"]["upsample"] >= 3)]
    if rec["eager_launches"]["adain"] < 6 * steps:
        failed.append("the eager run launched K1 fewer than 6 times a step")
    if rec["graph_replay_launches"] != {"adain": 6 * steps,
                                        "upsample": 6 * steps, "upconv": 0,
                                        "bottleneck": 0}:
        failed.append(f"graph replays {rec['graph_replay_launches']}")
    if rec["graph_built_during_capture"]:
        failed.append(f"built during capture {rec['graph_built_during_capture']}")
    require("dynamics", rec, failed)
    free_cuda()


# ---------------------------------------------------------- jax_resume

def phase_jax_resume(est_path, counters, launch_totals, smi):
    """Sub-phase jax_resume: a GAN run at full width (the cUNet with
    use_pallas, the SNDisc, the K4-routed ResNet-101 estimator; 224x224,
    batch 8, est mode, dropout 0), float32 (TF32 off) and bfloat16: two
    trainer steps, the state written in the JAX package's GanTrainState
    layout (train/checkpoint.py::gan_tree_to_jax, save_checkpoint_file)
    as ckpt_s0000000002.msgpack in a fresh save_dir, fresh trainers
    resumed from that directory eagerly and with aot_cache, and step 3 on
    each against the uninterrupted trainer's step 3 on the same batch."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    b, size = 8, 224
    rng = np.random.default_rng(SEED + 40)
    batches = [[(rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
                 rng.standard_normal((b, 5)).astype(np.float32))]
               for _ in range(6)]
    t_phase = time.perf_counter()
    want = {}
    # cuDNN's deterministic algorithms: its default backward ones may sum
    # in another order each run, which no checkpoint can carry
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        for dt in DTYPES:
            name = DT_NAME[dt]
            est = load_step_estimator(est_path, dtype=dt, device="cuda",
                                      route="k4")

            def trainer(save_dir, tier=False):
                with contextlib.redirect_stdout(io.StringIO()) as out:
                    tr = WeatherTransferTrainer(
                        GanConfig(input_size=size, batch_size=b, dtype=dt,
                                  dropout_rate=0.0),
                        est, save_dir=os.path.join(tmp, save_dir),
                        name="run", log_dir=os.path.join(tmp, "runs"),
                        device="cuda",
                        aot_cache=os.path.join(tmp, f"aot_{name}")
                        if tier else None)
                return tr, out.getvalue()

            def step(tr, k):
                with contextlib.redirect_stdout(io.StringIO()):
                    tr.train_epoch(batches[2 * k - 2], batches[2 * k - 1])
                return tr._last_metrics

            whole, _ = trainer(f"whole_{name}")
            for k in (1, 2):
                step(whole, k)
            pre = {n: v.detach().clone()
                   for n, v in state_tensors(whole.state).items()}
            path = os.path.join(tmp, f"jax_{name}", "run",
                                "ckpt_s0000000002.msgpack")
            t0 = time.perf_counter()
            ckpt.save_checkpoint_file(path, ckpt.gan_tree_to_jax(
                whole.state))
            rec = {"phase": "jax_resume", "dtype": name, "card": smi,
                   "batch": b, "size": size, "estimator_route": "k4",
                   "save_s": time.perf_counter() - t0,
                   "file_mib": os.path.getsize(path) / 2 ** 20}
            trs = {}
            for what in ("eager", "graph"):
                t0 = time.perf_counter()
                trs[what], out = trainer(f"jax_{name}", what == "graph")
                rec[f"{what}_resume_s"] = time.perf_counter() - t0
                rec[f"{what}_resumed"] = "resumed from" in out and (
                    trs[what].state.global_step, trs[what].state.gen.step,
                    trs[what].state.disc.step,
                    trs[what].state.epoch) == (2, 2, 2, 2)
            loaded = state_tensors(trs["eager"].state)
            rec["load_differs"] = sorted(
                k for k, v in pre.items()
                if k not in loaded or not torch.equal(loaded[k], v))
            want[dt] = gan_snapshot(whole.state, step(whole, 3))
            after = {n: v.detach().clone()
                     for n, v in state_tensors(whole.state).items()}
            # the uninterrupted step 3 once more from the same state: what
            # the step itself reproduces bit for bit on this card
            put_state(whole.state, pre)
            step(whole, 3)
            again = state_tensors(whole.state)
            rec["step_repeat_differs"] = sorted(
                k for k, v in after.items() if not torch.equal(again[k], v))
            del again
            (m, got_launches) = counted_run(lambda: step(trs["eager"], 3),
                                            counters, launch_totals)
            eager = gan_snapshot(trs["eager"].state, m)
            rec["eager_launches"] = got_launches
            mine = state_tensors(trs["eager"].state)
            rec["eager_step_differs"] = sorted(
                k for k, v in after.items()
                if k not in mine or not torch.equal(mine[k], v))
            rec["eager_losses_equal"] = eager["losses"] == want[dt]["losses"]
            with capture_watch() as watch:
                KeptGraph.replayed = []
                try:
                    m = step(trs["graph"], 3)
                    torch.cuda.synchronize()
                    replayed = KeptGraph.replayed
                finally:
                    KeptGraph.replayed = None
            graph = gan_snapshot(trs["graph"].state, m)
            rec["graph_replay_launches"] = replayed_kernels(replayed)
            rec["graph_captures"] = watch["captures"][0]
            rec["graph_built_during_capture"] = watch["built"]
            lr = whole.cfg.lr
            if dt == torch.float32:
                def floor_run(scale):
                    put_state(trs["eager"].state, pre)
                    tr = trs["eager"]
                    tr._step_rng.manual_seed(0)
                    u8, _ = batches[4][0]
                    r8, _ = batches[5][0]
                    from weather_unet_tpu_torch.data.transforms import (
                        normalize_batch)
                    x = normalize_batch(torch.from_numpy(u8).cuda(), size)
                    r = normalize_batch(torch.from_numpy(r8).cuda(), size)
                    z = torch.zeros(b, dtype=torch.long, device="cuda")
                    tr.state, mm = tr._step(tr.state, x * scale, z, r, z,
                                            tr._step_rng, do_g=True)
                    return gan_snapshot(tr.state, mm)

                errs = [snapshot_errs(floor_run(1 + s_ * ONE_ROUNDING),
                                      want[dt]) for s_ in (1, -1)]
                floor = {key: max(e[key] for e in errs)
                         for key in MOMENT_KEYS}
                # Adam's third update reaches sqrt(3) * lr where earlier
                # gradients were ~0: the sign-flip bound of step 3
                bar = lambda a, what: gan_states_agree(  # noqa: E731
                    a, want[dt], lr * np.sqrt(3), GAN_TOL,
                    f"jax_resume float32 {what}", floor)
            else:
                bar = lambda a, what: bf16_states_agree(  # noqa: E731
                    a, want[dt], want[dt], want[torch.float32],
                    f"jax_resume bfloat16 {what}")
            rec["eager_vs_whole"] = bar(eager, "eager")
            rec["graph_vs_whole"] = bar(graph, "graph")
            # bit for bit where the step reproduces itself; a tensor that
            # differs elsewhere is a fault of the resume (where the step
            # does not reproduce itself, the float32 bar above holds it)
            rec["eager_differs_beyond_repeat"] = sorted(
                set(rec["eager_step_differs"])
                - set(rec["step_repeat_differs"]))
            emit(rec)
            failed = [f"{w} did not resume" for w in trs
                      if not rec[f"{w}_resumed"]]
            # JAX keeps no v: the load recomputes weight_v from u, and the
            # step's forward overwrites it (no forward reads it)
            failed += [f"load differs at {k}" for k in rec["load_differs"]
                       if not k.endswith(".weight_v")]
            if dt == torch.float32 and (
                    rec["eager_differs_beyond_repeat"]
                    or (not rec["step_repeat_differs"]
                        and not rec["eager_losses_equal"])):
                failed.append(f"float32 eager resume not bit-equal: "
                              f"{rec['eager_differs_beyond_repeat'][:5]}")
            if got_launches != {"adain": 6, "upsample": 6, "upconv": 0,
                                "bottleneck": 58}:
                failed.append(f"eager launches {got_launches}")
            if rec["graph_replay_launches"] != {"adain": 6, "upsample": 6,
                                                "upconv": 0,
                                                "bottleneck": 58}:
                failed.append(f"graph {rec['graph_replay_launches']}")
            if rec["graph_built_during_capture"]:
                failed.append("built during capture "
                              f"{rec['graph_built_during_capture']}")
            require(f"jax_resume {name}", rec, failed)
            del whole, trs, est, pre, after, loaded, mine
            free_cuda()
    torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "jax_resume_done",
          "seconds": time.perf_counter() - t_phase})


def kernels_line(summary, launch_totals, graph_totals, split_summary,
                 split_totals, tf32_totals):
    meta = {
        "adain": ("weather_unet_tpu_torch/csrc/adain.cu",
                  "weather_unet_tpu/kernels/adain_pallas.py:74"),
        "upsample": ("weather_unet_tpu_torch/csrc/upsample.cu",
                     "weather_unet_tpu/kernels/upsample_pallas.py:170"),
        "upconv": ("weather_unet_tpu_torch/csrc/upconv.cu",
                   "weather_unet_tpu/kernels/upconv_pallas.py:145"),
        "bottleneck": ("weather_unet_tpu_torch/csrc/bottleneck_tc.cuh",
                       "weather_unet_tpu/kernels/bottleneck_pallas.py:92"),
    }

    every = {**summary, **split_summary}

    def totals(name, dt, sites):
        """One forward's worth of the kernel's records over ``sites``."""
        recs = [(every[name][dt][s], n) for s, n in sites.items()]

        def total(key):
            if any(r.get(key) is None for r, _ in recs):
                return None
            return sum(n * r[key] for r, n in recs)

        out = {"max_abs_err": max(r["max_abs_err"] for r, _ in recs),
               "ms": total("ms"), "launch_only_ms": total("launch_only_ms"),
               "device_ms": total("device_ms"),
               "cold_l2_ms": total("cold_l2_ms"),
               "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": max(recs, key=lambda rn: rn[1] * rn[0]["bound_ms"]
                               )[0]["bound_by"],
               "library_ms": total("library_ms"),
               "cuda_core_ms": total("cuda_core_ms"),
               "cuda_core_bound_ms": total("cuda_core_bound_ms")}
        if "gflop" in recs[0][0]:
            out["tflops"] = total("gflop") / out["launch_only_ms"]
            out["variant"] = {s: r["variant"]
                              for (r, _), s in zip(recs, sites)}
        return out

    entries = []
    for name, (source, replaces) in meta.items():
        per_dt = {}
        for dt in DTYPES:
            per_dt[DT_NAME[dt]] = totals(name, dt, MAIN_SITES[name])
            if name in GAN_SITES:
                per_dt[DT_NAME[dt]]["gan_step_forward"] = totals(
                    name, dt, GAN_SITES[name])
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launch_totals[name],
                 "graph_replay_launches": graph_totals[name],
                 **per_dt["bfloat16"], "dtype": "bfloat16",
                 "sites": MAIN_SITES[name],
                 "gan_sites": GAN_SITES.get(name),
                 "float32": per_dt["float32"]}
        entries.append(entry)
    split_meta = {
        "adain_split": ("weather_unet_tpu_torch/csrc/adain.cu",
                        "weather_unet_tpu/kernels/adain_pallas.py:74",
                        "wut_adain_stats + wut_adain_apply (which "
                        "merges the shards' statistics itself); device_ms "
                        "is the two kernels' (device_ms_by_kernel in the "
                        "spatial_kernel records), the exchange's "
                        "stand-in's on the spatial_stand_in lines; ms is "
                        "the wall of the pair, stand-in included"),
        "upsample_rows": ("weather_unet_tpu_torch/csrc/upsample.cu",
                          "weather_unet_tpu/kernels/upsample_pallas.py:170",
                          "wut_upsample2x_rows; float32's library_ms is one "
                          "F.grid_sample (bilinear, align_corners) of the "
                          "slab on the window's grid, built untimed; its "
                          "grid takes the slab's dtype, and in bfloat16 "
                          "misplaces the taps (its spatial_kernel records' "
                          "library_max_abs_err), so "
                          "bfloat16 has none")}
    sites = {k: 1 for k in SPLIT_SITES}
    for name, (source, replaces, note) in split_meta.items():
        per_dt = {DT_NAME[dt]: totals(name, dt, sites) for dt in DTYPES}
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": split_totals[name],
                        "graph_replay_launches": None,
                        **per_dt["bfloat16"], "dtype": "bfloat16",
                        "sites": sites, "float32": per_dt["float32"],
                        "note": note})
    # the float32 tensor-core forms: their numbers are the float32
    # records of their kernel's sites, which the rule sent there
    tf32_meta = {
        "bottleneck_3xtf32": "built as csrc/bottleneck_f32tc16{,c}.cu; "
                             "float32 as split float32, three TF32 mmas a "
                             "product; cuda_core_ms: bottleneck_kernel, "
                             "the kernel it replaces",
        "upconv_3xtf32": "tc::run<float>; float32 as split float32, three "
                         "TF32 mmas a product; cuda_core_ms: the CUDA-core "
                         "upconv_kernel it replaces"}
    for name, kernel in TF32_FORMS.items():
        source, replaces = meta[kernel]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": tf32_totals[name],
                 "graph_replay_launches": None,
                 **totals(kernel, torch.float32, MAIN_SITES[kernel]),
                 "dtype": "float32", "sites": MAIN_SITES[kernel],
                 "gan_sites": GAN_SITES.get(kernel),
                 "note": tf32_meta[name]}
        if kernel in GAN_SITES:
            entry["gan_step_forward"] = totals(kernel, torch.float32,
                                               GAN_SITES[kernel])
        entries.append(entry)
    emit({"kernels": entries})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this "
                         "script runs the port on a GPU")
    from weather_unet_tpu_torch.kernels import (
        adain as k1, bottleneck as k4, upconv as k3, upsample as k2)
    from weather_unet_tpu_torch.models import ConditionalUNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"adain": k1, "upsample": k2, "upconv": k3, "bottleneck": k4}

    smi = phase_env()
    phase_build()
    aot_server_starts(smi)
    summary = phase_kernels()

    launch_totals = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(SEED)
        path = os.path.join(tmp, "cunet.pt")
        torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                    "global_step": 0}, path)
        tf32_totals = {name: 0 for name in TF32_FORMS}
        wts = phase_e2e(path, counters, launch_totals, tf32_totals)
        phase_serve(wts["fuse_upconv", torch.float32], counters,
                    launch_totals)
        est_path = os.path.join(tmp, "estimator.pt")
        make_estimator_checkpoint(est_path)
        phase_estimator(est_path, wts["use_pallas", torch.float32], counters,
                        launch_totals, tf32_totals)
        gan_records = phase_gan(est_path, counters, launch_totals,
                                tf32_totals)
        # the phases whose results no later phase reads: a failed check is
        # recorded and the script goes on, so that one run shows every
        # phase and the kernels line; it still exits nonzero, without the
        # last line, at its end
        failed = []

        def checked(name, phase, *args):
            try:
                phase(*args)
            except AssertionError as e:
                failed.append(f"{name}: {e}")
                emit({"phase": f"{name}_failed", "error": str(e)[:4000]})
                free_cuda()

        checked("dynamics", phase_dynamics, counters, launch_totals, smi)
        checked("jax_resume", phase_jax_resume, est_path, counters,
                launch_totals, smi)
        checked("train", phase_train, est_path, counters, launch_totals,
                gan_records, smi)
        checked("supervised", phase_supervised, counters, launch_totals, smi)
        checked("serving_cli", phase_serving_cli, est_path, counters,
                launch_totals, smi)
        checked("eval_export", phase_eval_export, counters, launch_totals,
                smi)
        checked("surface", phase_surface, counters, launch_totals, smi)
        checked("parallel", phase_parallel, path, est_path, counters,
                launch_totals, smi)
        checked("tensor_parallel", phase_tensor_parallel, path, est_path,
                counters, launch_totals, smi)
        split_totals = {k: 0 for k in SPLIT_NAMES}
        split_summary = phase_spatial(path, est_path, counters,
                                      launch_totals, split_totals, smi)
        graph_totals = {k: 0 for k in counters}
        checked("aot", phase_aot, est_path, smi, graph_totals)
    for name, total in launch_totals.items():
        if total == 0:
            failed.append(f"{name} kernel never ran on the main path")
        if graph_totals[name] == 0:
            failed.append(f"{name} kernel never ran in a CUDA-graph replay "
                          "of phase aot")
    for name, total in split_totals.items():
        if total == 0:
            failed.append(f"{name} never ran on the spatial paths")
    for name, total in tf32_totals.items():
        if total == 0:
            failed.append(f"{name} never ran on the float32 paths")
    emit({"phase": "total", "seconds": time.perf_counter() - START,
          "cuts": CUTS, "failed": failed})
    kernels_line(summary, launch_totals, graph_totals, split_summary,
                 split_totals, tf32_totals)
    if failed:
        raise AssertionError("chip_smoke failed:\n" + "\n".join(failed))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
