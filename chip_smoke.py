#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``vanerf_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing what it found; any failed check raises and the
script exits non-zero (there is no CPU fallback):

  1. build (or reuse) the twenty-three CUDA kernel entry points from
     ``vanerf_tpu_torch/csrc`` (the fifteen float32 ones, the bfloat16
     forms of D, 10, 11, 12, 13 and 14, and 11 / 12's bfloat16 body for
     other widths);
  2. each kernel against its plain-PyTorch twin on the card, at the shapes
     the main path gives it (a 64x64-ray patch x 64 samples = 262,144
     points, the 256^2 subdiv=3 two-hand fixture: 2,560 faces, 1,284
     vertices; for the fused kernels the packs and KNN rows that the
     model's own level-1 / level-2 branches make for those points, the
     weights packed once as the model packs them for a frame), with
     its time beside the twin's, beside the least time the card could take
     (bytes over 3.35 TB/s or operations over 67 TFLOP/s f32, whichever is
     larger) and, where one PyTorch call computes the same function, that
     call's time; the exact queries (kernels 5 and 6) in both winding
     modes, bit-equal in ray mode and to 1e-5 on the winding in solid-angle
     mode, each mode also timed from a CUDA graph on its face table beside
     the issue-rate bound of the work it does (``brute_work``: a sphere
     test a pair, the distance where a warp keeps the face, the winding
     term a pair), with nvcc's register and spill counts; the
     coordinate-major kernels 7 and 8 also bit-equal to A and B
     on the transposed input; kernel 9 (the culled nearest-vertex search)
     bit-equal to B and 8, its visits those of ``knn_cull_lists``, on the
     main path's order (where every chunk is visited) and on the same
     points and vertices in Morton order (where chunks must be skipped),
     timed from a CUDA graph, its chunk-box kernel alone beside it (its
     rows equal to ``vertex_chunk_boxes``), with nvcc's counts; and on
     the main path's points against the two synthetic MANO hands posed by
     ``mano_forward_np`` and sealed (2 x 779 vertices in MANO's order),
     bit-equal to B, its visit share and times beside B's;
     kernels
     A and 7 are the culled mesh query, in 16-ray x 8-sample tiles and in
     ``VANERF_BLOCK_2D=4,4,8`` tiles, without and with the far tier:
     bit-equal to the plain version, to the sweep over every face of the
     same sorted table in d2, idx and qvis, in the winding on every tile
     that keeps +d and up to certified grazes on tiles that take -d, and in
     d2 to the sweep over the table in mesh order; timed in turns with the
     sweep; also in tiles of consecutive points, and under
     ``VANERF_CULL_EARLY=1`` (equal to their plain version, d2 and the
     winding to the default walk's, another face only on an exact tie,
     timed in turns with the default walk); A at every tile x chunk size
     it is built for (``VANERF_MESH_TILE_P`` 64 / 128 / 256 x
     ``VANERF_CULL_CHUNK`` 64 / 128), equal to its plain version and the
     sweep; kernel C (the tiled rasterizer) on the source view's 256^2
     raster and on ``raster_cases``' (the frame's vertex visibility at
     256^2 and 64^2, a 250x250 raster, the train step's target view, a
     distant mesh in one tile, faces off the raster, slivers and degenerate
     faces, vertices on pixel centres with ties, large and non-finite
     coordinates), each face id and depth equal to the sweep over every
     face (``raster_plain``), timed as called and as the device runs it
     beside an empty kernel; kernels 11 and 12 (3xTF32 on the tensor
     cores) also timed from a CUDA graph, with the bound of their products
     at the TF32 rate and nvcc's register and spill counts; kernels D and
     13 at each main-path shape and at edge cases (D:
     6 channels on scalar lanes, a slice of a batch, a table or a uv off a
     16- / 8-byte boundary, points beyond [-1, 1]; 13: no point, one
     point, both sides of the one-launch limit, every point on one row, 5
     channels, a gradient off a 16-byte boundary), each bit-equal across
     two runs, D also to its plain version, each timed as called (CUDA
     events over 20 calls, as every kernel is) and as the device runs it
     (calls replayed from a CUDA graph), beside ``F.grid_sample`` /
     ``index_add_`` in the same run, and the float4 or scalar-lane
     instantiation it launched (from torch.profiler's kernel names);
     kernel 14 (``feat_sample_nhwc``'s sampler, which replaces no TPU
     kernel) on the three maps the main path samples through it (the
     256^2 x 4 mask + image, the 128^2 x 8 fine geometry and 64^2 x 8
     texture maps) at the patch's points, at a 16-tile group's and a
     two-view group's launch, on a 64^2 x 16 map, in bfloat16 and on
     scalar lanes and unaligned bases: bit-equal to
     ``feat_sample_nhwc_plain`` and across two runs, timed as D is beside
     the plain version and ``F.grid_sample``;
  2b. the bfloat16 forms of D, 10, 11 and 12 on what the bfloat16 model's
     own branches hand them for the same patch (``VANeRF.from_config``
     under ``VANERF_COMPUTE_DTYPE=bfloat16``, the same weights): D (the
     32^2 x 64 map in bfloat16, and the scalar-lane, unaligned and sliced
     cases) and 10 (the 1,284 x 204 bfloat16 table) bit-equal to their
     plain versions; the softplus and sigmoid of 11 and 12 on all 65,536
     bfloat16 inputs equal to the plain version's, bit for bit; 11 and 12
     (csrc/fused_mlp_bf16.cu: wgmma m64nNk16, one bfloat16 product a
     16-row k-step; threads, shared bytes and blocks an SM from
     ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` printed)
     within ``FUSED_BF16_SPREAD_X`` times the RMS spread between two
     summation orders of their plain versions, each output (which the
     plain versions without their roundings must fail), each element within
     twice the plain version's bfloat16-vs-float32 spread; times called
     and from a CUDA graph, bounds (11 / 12: the bfloat16 tensor rate plus
     the CUDA cores' f32 work), plain and library times (``F.grid_sample``
     on the bfloat16 map with its grid in bfloat16, ``index_select``),
     nvcc's registers and spills; 13 in bfloat16 at phase 2's four
     training-path shapes and on scalar lanes: equal to the float32 kernel
     on the rows widened to float32, rounded once to bfloat16, bit for bit,
     within one bfloat16 unit of its plain version, two runs equal, timed
     as called and from a CUDA graph beside the float32 form's device time
     and ``index_add_`` of the widened rows plus one cast;
  3. the serving path at full model width (``configs/vanerf.json``, seeded
     flax-style initialisation): ``render_full_image`` for 2 frames (16
     64x64 tiles each, 64+64 samples) and one bench-shaped group of 16
     mask-centred 64x64 patches; the launch counters of A-D and of the row
     gather (kernel 10, which every render without a graph takes) must
     move;
  3a. two ``encode_frame`` calls of one frame equal to the bit (the
     encoders run under cuDNN's deterministic algorithms); with that pin
     lifted, forward hooks name the first module whose output differs
     between two calls, and the encode is timed with and without the pin;
  3g. the same frame with kernel D (the default) and under
     ``VANERF_MXU_INTERP=0`` in turns, on one shared encode: 32 launches
     of D a frame and none under the switch, every output within rtol
     1e-3 / atol 1e-4 as 3b holds its frames (the hat and the lerp form
     of one bilinear sample round differently);
  3b. the fused-MLP serving configuration on the same frame, in turns with
     the unfused render (far tier off in all three, as the switch has it):
     ``VANERF_FUSED_MLP=2`` (kernel 11) and ``VANERF_FUSED_MLP=1``
     (kernel 12): one full image and the 16-patch
     group each, every output within rtol 2e-4 / atol 2e-5 of the unfused
     one, ms/frame beside the unfused ms/frame;
  3h. the bfloat16 serving configuration on the same frame: unfused (far
     tier on), ``VANERF_FUSED_MLP=1`` and ``=2``, each in turns with the
     float32 frame under the same switches: ms/frame, PSNR of the bfloat16
     frame against the float32 one, launches of the bfloat16 D and 10 (and
     12 or 11) > 0 and none of their float32 forms (and no bfloat16 form on
     a float32 frame); an 8x8-ray patch of each configuration on the card
     against the CPU port's in bfloat16, both from the CPU's encode and
     with the CPU bfloat16 patch's fine depths, each
     element within 2 S + 1e-4 + 1e-3 |x|, S the CPU port's
     bfloat16-vs-float32 spread on that patch, and the RMS error within
     S_rms / 2 + 2 E_rms, which the card's float32 patch must fail
     (``BF16_CPU_RAYS``);
  3i. the tile group: kernels B, 8, A, 7 (far tier on), D and 10 (float32
     and bfloat16) each launched once over two different frames x 2 tiles
     and over one frame's 16-tile group (its coarse pass at level 3), every
     element equal to the bit to its own launch; at the 16-tile group each
     batched launch's device time (a CUDA graph) beside its element 0's
     and the batched launch's bound; then the 256^2 frame at
     ``tile_group`` 1, 4 and 16 in turns on one shared encode: ms, peak
     memory, 2 s^2 / G = 32 / 8 / 2 launches of each of B, A, D and 10 a
     frame, device ops and busy time of one more frame under
     torch.profiler, and each G > 1 frame held to the G = 1 frame as 3b
     holds the fused frames (the largest difference printed); then one
     short run of ``vanerf_tpu_torch.bench`` serving (G = 16) and
     training, each JSON object printed on a line;
  3c. the coordinate-major serving configuration on the same frame:
     ``VANERF_SOA_POINTS=1`` and ``=2`` in turns with mode 0 (far tier on,
     the default), every output equal to mode 0's (the compared frames
     share one encode); kernels 7 and 8 must launch and A and B must not;
  3e. the same frame under ``VANERF_KNN_CULL=1``, pixel-major and under
     ``VANERF_SOA_POINTS=1 VANERF_BLOCK_2D=4,4,8``, in turns with the
     default frame: every output equal to the same layout's frame without
     the switch, 32 launches of kernel 9 a frame and none of B (or 8);
     kernel 9's (tile, chunk) visit share on each pass of one more frame
     of each layout;
  3f. the serving tiers on the same frame, in turns with the default:
     ``VANERF_FAR_SKIP=1`` held as 3b holds the fused frames,
     ``VANERF_FAR_SKIP=0.5``, ``VANERF_FAR_NET=0.5`` and
     ``VANERF_FAR_TNET=0.5`` finite, one 8x8-ray patch of each equal to the
     CPU port's to rtol 1e-3 / atol 1e-4 (the fine outputs of a ray whose
     coarse + fine merge is certified to order two samples of one depth
     differently on the two devices: to 0.02), PSNR against the default
     frame;
  3d. the exact mesh-query API on the points of one 64x64x64 pass:
     ``cal_vis_sdf_fast`` under ``VANERF_WINDING=ray`` and ``=solid_angle``
     (kernel 6) and ``point_mesh_sdf`` (kernel 5) against the renderer's
     query with the far tier off;
  4. one 16x16-ray patch rendered on the card (kernels) and on the CPU
     (plain twins) with the same weights;
  5. training at full width: 3 faithful GAN steps
     (``training.make_train_step``) on mask-centred 64x64 patches with
     64+64 samples, a seeded ``DiscriminatorVis`` and a
     VGG19 with the flax-default initialisation drawn from seed 19; every
     loss and parameter must stay finite and the kernels of the training
     path (A, B, C and the scatter 13) must each launch; prints ms/step
     (steps 2-3) and the peak device memory;
  5b. the same 3 steps from the same weights and draws under
     ``VANERF_FUSED_TRAIN=2``: kernel 11 must launch in the G render, every
     loss stays finite, and the first step's G loss lies within 5e-3
     relative of the unfused first step's;
  5c. one faithful GAN step under ``VANERF_SOA_POINTS=1`` from the same
     weights and draws: kernels 7 and 8 launch in both renders and the G
     loss lies within 1e-5 relative of phase 5's first step's;
  5d. 3 faithful GAN steps of the bfloat16 model (``VANeRF.from_config``
     under ``VANERF_COMPUTE_DTYPE=bfloat16``, the same weights) in turns
     with 3 float32 steps: ms/step and peak memory of each, every loss and
     parameter finite; A, B, C and the bfloat16 scatter 13 launch, kernel D
     and every float32 form of D, 10, 11, 12 do not, the float32 13 as
     found; what torch's native gather's backward does on a bfloat16 table;
  5e. the bfloat16 model under ``VANERF_FUSED_TRAIN=2`` and ``=1``: the
     bfloat16 kernel 11 / 12 4 times a step, the renders without a graph
     through the bfloat16 D and 10, the first G loss within 5e-3 relative
     of 5d's first bfloat16 step's;
  6. one G-loss gradient on a 16x16-ray training patch with the same
     draws on the card (kernels) and on the CPU (plain twins): the loss
     and each parameter's gradient norm compared; then the same in
     bfloat16 on both devices from the CPU's encode: every tensor holding
     at least 1e-3 of the gradients' norm within S / 2 + 2 E (RMS; S the
     CPU port's bfloat16-vs-float32 spread, E the card's float32 gradient
     against the CPU's), which the card's float32 gradients must fail;
  5f. train-step determinism, float32 and bfloat16: two steps from one
     state and one seed of draws equal to the bit (the step runs under
     cuDNN's deterministic algorithms, with the port's atomic-free
     replication pad and adaptive pool); without those three the same
     comparison, with forward hooks and gradient hooks on every leaf
     module naming the first output and the first gradient that differ;
     the ops torch flags as without a deterministic implementation (none
     may be); the three's cost, 4 steps each in turns;
  7. the entry point, ``vanerf_tpu_torch.train.main`` in process at full
     width (``configs/vanerf.json``, a ``synthetic_cfg`` of one 256^2
     subdiv-3 frame x 8 cameras, validation every half epoch):
     ``--fast_dev_run`` (one step, config.json and metrics.jsonl); one
     epoch of ``fit`` (8 steps), the launches of A, B, C, 13 and 10 held to
     the steps as phase 5 holds them (validation's launches counted apart)
     and ``val_fn`` run at steps 4 and 8; a second invocation that resumes
     from the checkpoint, its state equal to the bit to the saved one;
     ``--run_val --model_ckpt <the ckpts dir>``, 16 frames, a report with
     finite psnr / ssim / mse and ``lpips_pretrained: false``; prints fit's
     ms/step (loading and logging included) beside its steps timed alone
     and phase 5's bare step, and run_test's ms/frame;
  8. the free-viewpoint video, ``vanerf_tpu_torch.render_dynamic.main`` in
     process at full width (``configs/vanerf.json``, the 256^2 subdiv-3
     fixture, 20 orbit frames, its model equal to the seeded model of the
     other phases): the launches of A, B, C, D and 10 a frame (the
     dataset's raster counted apart), at least one frame with foreground;
     the 20 PNGs read back equal to the frames, ``nvs.mp4``'s 20 JPEG
     samples, ``nvs.gif``'s 20 image blocks; orbit camera 0 rendered again
     equal to its frame to the bit; its 8x8-ray patch on the card within
     phase 4's tolerance of the CPU port's, the CPU query taking the card's
     visibility on the samples where a tie is certified
     (:func:`certify_ties`); prints ms a frame (the first, the median of
     the rest), device ops and busy ms of one profiled frame, the peak, and
     the PNG, JPEG and GIF encoders' host ms a frame;
  9. two source views (``dataset.num_input_view = 2``, the fixture's first
     frame with two source views, full width): 9a kernels D and 10 over
     the element-views (element e view v at e V + v, map (e V + v) mod
     (Bf V)) of one frame and of a 16-tile group, one launch each, equal to
     the bit to every element-view's own launch and to the plain version,
     the 16-tile group's device time beside its bound; kernel 13 on each
     view's training tables within 1e-5 of the row's sum of |g|; 9b the
     256^2 frame at ``tile_group`` 1 and 16: the first frame's ms, peak and
     launches (A, B, D, 10 32 / G, C 1: the points and meshes are the
     frame's), two rounds in turns with the one-view frame, device ops and
     busy ms of one profiled frame, G = 16 held to G = 1 as 3i holds it;
     an 8x8-ray patch on the card within phase 4's tolerance of the CPU
     port's, ties certified as in phase 8; 9c 3 faithful GAN steps at two
     views (ms/step, peak, launches as phase 5 holds them, the IBR head's
     gradient non-zero every step) and two steps from one state equal to
     the bit, as in 5f; 9d the entry point on a two-view config written
     under ``build/`` (one epoch of ``fit`` with ``val_fn``, then
     ``--run_val`` on its checkpoint), every query at two views, the
     report finite;
  10. the offline preprocessor and the config variants: 10a
     ``dataset_process.render_view`` (kernel C at InterHand2.6M's raw
     512x334, the two synthetic MANO hands, the raw fixture's four
     cameras) on the card equal to the bit to the CPU port's (mask,
     densepose, bbox, the crop's intrinsics), one launch of C a view, ms a
     view and C alone beside its work's bound; 10b each of the nine other
     ``sp_type``s (``mxyz`` / ``rel_mxyz`` with a fixed rigid
     ``model_T``) and ``VANERF_PE_DIRECT=1``: an 8x8-ray patch at full
     width on the card against the CPU port's (phase 4's tolerance, ties
     certified as in phase 8) and the 256^2 frame at ``tile_group`` 16
     (ms, busy ms, device ops, peak) beside the default frame's; 10c the
     five other activations, ``[max, mean, var]`` pooling and the texture
     encoder's group / none norms: the same patch check; 10d
     ``VANERF_REMAT_QUERY=1`` and ``=2``: 3 faithful GAN steps each, every
     loss equal to the bit to phase 5's, ms/step and peak; 10e
     ``VANERF_TWO_RES=1`` on a texture map coarser than the fine geometry
     map: the frame against the same model's without the switch, ms in
     turns, kernel 10's launches (the packed table's gather); 10f the
     bfloat16 frame of a model at other MLP widths under
     ``VANERF_FUSED_MLP=1`` / ``=2``: the mma.sync body launches, the
     wgmma body does not.  Phase 2b holds that body at those widths against
     the plain version as it holds the wgmma body.
  11. ``sp_conv: true`` at full width (configs/vanerf.json on the 64^3
     voxel grid, built as phase 10 builds its variants): 11a an 8x8-ray
     patch on the card against the CPU port's (phase 4's tolerance, ties
     certified); 11b the 256^2 frame at ``tile_group`` 1 and 16 in turns
     with the default frame (ms, busy ms, device ops, peak, each kernel's
     launches: A / B 32 / G, C 1, kernel 10 three gathers a pass); 11c one
     two-view G = 16 frame; 11d 3 faithful GAN steps (ms/step, peak, every
     loss and parameter finite, the voxel U-nets' gradients non-zero) and
     two steps from one state equal to the bit.
  12. data parallelism (``vanerf_tpu_torch/parallel``) on the one card:
     12a NCCL at world size 1 set up as torchrun sets a rank up (env://):
     the parallel GAN step (its all-reduces and first-step broadcast over
     NCCL) equal to the bit to the plain step, ``render_full_image(mesh=)``
     equal to the bit to the plain frame; 12b two gloo processes on the
     card with the real kernels: a 2-rank step on a global batch of 2
     equal to the bit to this process's average of the two shards' steps,
     the sharded G = 16 frame equal to the bit to the single-device G = 8
     frame and held to the G = 16 one by phase 3i's rule.  NCCL will
     not put two ranks on one card: N >= 2 over NCCL needs N cards.

A ``details:`` line holds every measured number; the line before the last
is a JSON object with one entry per kernel (its launches are those of the
phase that drives it: A-D and 10 phase 3, 13 phase 5, 13 in bfloat16
phase 5d's bfloat16 steps, 11 the level-2 run
of phase 3b, 12 the level-1 run, the bfloat16 D and 10 phase 3h's unfused
bfloat16 frame, 11 / 12 in bfloat16 its level-2 / level-1 frames, their
mma.sync body phase 10f's, 7 and 8 the mode-1 run of phase 3c, 9 the
two culled runs of phase 3e, 5 and 6 phase 3d; D and 10 also carry
``views_launches`` (a two-view G = 1 frame) and ``views_g16_device_ms`` /
``views_g16_bound_ms`` (one launch over 32 element-views), 13
``views_launches`` a two-view step (phase 9); A and 7 carry the sweep's
time beside the culled query's as ``brute_ms``; D and 13 sum the cases
they have summed since their port, D's two maps and 13's four tables (13
in bfloat16 the same four), and
carry their graph-replayed times as ``device_ms`` / ``library_device_ms``;
A, 7, B, 8 and 9 carry ``device_ms`` and ``issue_bound_ms``, their
operations at 33.5 T op/s, the rate of separately rounded f32 operations
(9: over the visited pairs, its chunk-box kernel included in the times); A
and 7 also ``work_issue_bound_ms``, the operations the kernel evaluates at
that rate: a sphere test for every visited pair, the full distance only for
the faces a warp keeps, ``ops/mesh_query.py::culled_work``; 5 and 6 carry
``device_ms`` (the kernel on its table) and ``work_issue_bound_ms``
(``ops/mesh_query.py::brute_work``), each the sum of the two winding
modes, as their ``ms``; C carries ``device_ms``
and ``work_issue_bound_ms``, its (tile, face) tests and walked (pixel,
face) pairs, ``ops/rasterize.py::raster_work``, at that rate, its
``bound_ms`` the walked pairs at the f32 rate; 11 and 12 carry
``device_ms`` and ``tensor_bound_ms``, three TF32 passes of their
multiply-adds at 495 TFLOP/s and their CUDA-core work at the f32 rate;
their bfloat16 forms one pass at 989 TFLOP/s plus the same CUDA-core work,
which is also their ``bound_ms`` where it exceeds the bytes' time);
the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and
convolutions.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 256
SUBDIV = 3
PATCH = 64
S_C = S_F = 64
SEED = 0

KERNELS = {
    "mesh_query": ("vanerf_tpu_torch/csrc/mesh_query.cu",
                   "vanerf_tpu/ops/mesh_query_pallas.py:1027"),
    "knn": ("vanerf_tpu_torch/csrc/knn.cu",
            "vanerf_tpu/ops/knn_pallas.py:49"),
    "mesh_query_brute": ("vanerf_tpu_torch/csrc/mesh_query_brute.cu",
                         "vanerf_tpu/ops/mesh_query_pallas.py:395"),
    "mesh_query_vis_brute": ("vanerf_tpu_torch/csrc/mesh_query_brute.cu",
                             "vanerf_tpu/ops/mesh_query_pallas.py:467"),
    "mesh_query_T": ("vanerf_tpu_torch/csrc/mesh_query.cu",
                     "vanerf_tpu/ops/mesh_query_pallas.py:1219"),
    "knn_T": ("vanerf_tpu_torch/csrc/knn.cu",
              "vanerf_tpu/ops/knn_pallas.py:325"),
    "knn_culled": ("vanerf_tpu_torch/csrc/knn.cu",
                   "vanerf_tpu/ops/knn_pallas.py:245"),
    "knn_T_culled": ("vanerf_tpu_torch/csrc/knn.cu",
                     "vanerf_tpu/ops/knn_pallas.py:245"),
    "rasterize": ("vanerf_tpu_torch/csrc/rasterize.cu",
                  "vanerf_tpu/ops/rasterize_pallas.py:73"),
    "interp_mxu": ("vanerf_tpu_torch/csrc/interp.cu",
                   "vanerf_tpu/ops/interp_mxu.py:92"),
    "onehot_scatter": ("vanerf_tpu_torch/csrc/onehot_scatter.cu",
                       "vanerf_tpu/ops/onehot_gather.py:86"),
    "row_gather": ("vanerf_tpu_torch/csrc/row_gather.cu",
                   "vanerf_tpu/ops/interp_mxu.py:205"),
    "fused_query_mlp": ("vanerf_tpu_torch/csrc/fused_mlp.cu",
                        "vanerf_tpu/ops/fused_mlp.py:365"),
    "fused_geo_mlp": ("vanerf_tpu_torch/csrc/fused_mlp.cu",
                      "vanerf_tpu/ops/fused_mlp.py:431"),
    # the bfloat16 forms (VANERF_COMPUTE_DTYPE=bfloat16; phases 2b, 3h)
    "interp_mxu_bf16": ("vanerf_tpu_torch/csrc/interp.cu",
                        "vanerf_tpu/ops/interp_mxu.py:92"),
    "row_gather_bf16": ("vanerf_tpu_torch/csrc/row_gather.cu",
                        "vanerf_tpu/ops/interp_mxu.py:205"),
    "fused_query_mlp_bf16": ("vanerf_tpu_torch/csrc/fused_mlp_bf16.cu",
                             "vanerf_tpu/ops/fused_mlp.py:365"),
    "fused_geo_mlp_bf16": ("vanerf_tpu_torch/csrc/fused_mlp_bf16.cu",
                           "vanerf_tpu/ops/fused_mlp.py:431"),
    # their body for the widths the wgmma body is not built for (the
    # mma.sync body of csrc/fused_mlp.cu; phases 2b, 10f)
    "fused_query_mlp_bf16_mma": ("vanerf_tpu_torch/csrc/fused_mlp.cu",
                                 "vanerf_tpu/ops/fused_mlp.py:365"),
    "fused_geo_mlp_bf16_mma": ("vanerf_tpu_torch/csrc/fused_mlp.cu",
                               "vanerf_tpu/ops/fused_mlp.py:431"),
    # (bfloat16 training; phases 2b, 5d)
    "onehot_scatter_bf16": ("vanerf_tpu_torch/csrc/onehot_scatter.cu",
                            "vanerf_tpu/ops/onehot_gather.py:86"),
}
TRAIN_STEPS = 3
# phase 5f: steps pinned and unpinned in turns, for the pins' cost (the
# first of each left out of the median)
REPEAT_ROUNDS = 4
# The card's published peaks (H100 SXM): device memory rate and the f32
# rate outside the tensor cores, which is the type every kernel here uses.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# The rate at which the card issues separately rounded f32 adds and
# multiplies: the kernels built with -fmad=false (A-D, 5-9) cannot fuse a
# product into a sum, so each operation takes an issue slot of its own and
# the f32 peak, which counts a fused multiply-add as two, halves.
ISSUE_OPS_PER_S = 33.5e12
# Operations per (point, face) / (point, vertex) / (pixel, face) pair, as
# the kernels' sources do them: kernel A's distance is 15 differences, 6
# dot products (30), 3 cross terms (9), the closest point's distance (8)
# and 3 comparisons at the least (a vertex region; the other regions cost
# more), its signed crossing test 3 differences, 3 dot products (15), 6
# products and sums, 4 comparisons and the sum; kernel B 3 differences, 5
# for the squared norm and a comparison; kernel C 4 edge functions of 7,
# 3 divisions and 5 comparisons.  Kernels 5 and 6 test the crossing with
# the unfolded constants: a cross product (9) more.  Their solid angle is 9
# differences, 3 norms (6 each, the root as one), a cross product (9), 4
# dot products (20), the denominator (8) and the atan2, its doubling and
# the sum (3).
MESH_DIST_OPS = 65
MESH_CROSS_OPS = 29
# The culled kernel's per-face sphere test before the distance: 3
# differences, the squared norm (5), the sum and square of the radius and
# the comparison.
MESH_SPHERE_OPS = 11
MESH_CROSS_UNFOLDED_OPS = 38
MESH_SOLID_ANGLE_OPS = 67
# kernels 5 and 6 in solid-angle mode against their plain versions: sqrtf
# and atan2f need not round as torch's do and the sum's order differs
SOLID_WIND_ATOL = 1e-5
# phase 3d: the exact API against the renderer's query (other barycentrics
# off a face's interior, tests/test_pallas_kernels.py:91)
API_SDF_RTOL, API_QVIS_AGREE = 1e-4, 0.97
# kernel 5's crossing counts against kernel A's: at most this share of the
# points may differ, each within this margin (barycentric units) of an edge
GRAZE_SHARE, GRAZE_MARGIN = 1e-4, 1e-4
SOA_ROUNDS = 2
# phases 3e / 3f: rounds of the culled-search and serving-tier frames
CULL_ROUNDS = 2
TIER_ROUNDS = 2
# phase 3f: a tier's patch on the card against the CPU port's (phase 4's
# tolerance; 8x8 rays, a quarter of phase 4's patch: the CPU render at full
# width is what takes the time)
TIER_CPU_RAYS = 8
TIER_CPU_RTOL, TIER_CPU_ATOL = 1e-3, 1e-4
# ... except on rays whose coarse + fine merge orders two samples of (nearly)
# one depth differently on the two devices: see ``merge_order_flips``.  At
# most this share of the patch's rays, the depths within this relative
# margin of each other, their fine outputs within FUSED_FINE_ABS
TIER_FLIP_SHARE, TIER_FLIP_MARGIN = 0.05, 1e-6
# kernel 9's visit counts against the plain version's: a (tile, chunk) may
# differ only where its lower bound lies this close (relative, float64) to
# the threshold
KNN_VISIT_MARGIN = 1e-5
# phase 5c: the SoA step's G loss against mode 0's.  The two steps encode
# the frame for themselves, and the encoders do not repeat to the bit on
# the card (see phase 3c), so the losses agree to rounding, not to the bit.
SOA_TRAIN_LOSS_RTOL = 1e-5
KNN_OPS = 9
RASTER_OPS = 36
# What kernel C issues (csrc/rasterize.cu), in f32 issue slots: a (pixel,
# face) pair of the walk is the area and three edge functions (7 each),
# the `ok` test (2), three IEEE divisions (~9 instructions each: a
# reciprocal, its refinement and the rounding check) and the comparisons
# (5); the depth of the pairs inside is left out; a (tile, face) test is
# the area (7), the `ok` test (2), the box (8) and its comparison with the
# tile (4); where the box misses the tile the float64 certificate follows,
# ~118 operations at half the f32 rate.
RASTER_PAIR_ISSUE = 62
RASTER_TEST_OPS = 21
RASTER_CERT_F64_OPS = 118
# The tensor cores' dense TF32 rate (H100 SXM): kernels 11 / 12 run every
# layer product three times in TF32 (3xTF32)
TF32_FLOPS_PER_S = 495e12
# the fused kernels against their plain versions, and the fused renders
# against the unfused one (tests/test_renderer_train.py:155)
FUSED_RTOL, FUSED_ATOL = 2e-4, 2e-5
FUSED_FINE_SHARE, FUSED_FINE_ABS = 0.01, 0.02
FUSED_TRAIN_LOSS_RTOL = 5e-3
# The tensor cores' dense bfloat16 rate (H100 SXM): kernels 11 / 12 in
# bfloat16 run every layer product once on them
BF16_FLOPS_PER_S = 989e12
# kernels 11 / 12 in bfloat16 against their plain versions: each output's
# RMS error at most this multiple of the RMS spread between two summation
# orders of the plain version (every layer product's 16-row k-tiles summed
# forward, as one product, and in reverse), the bfloat16 rounding of each
# layer being what decides both; the plain version without its roundings
# (float32 between layers) must fail that bound.  The largest error is no
# such gate: it is one flipped rounding, whose size is the bfloat16 unit of
# the value it lands on, so its ratio to the largest spread moves by powers
# of two, and the control sits near 2x there too.  Each element is held
# instead within twice the plain version's own bfloat16-vs-float32 spread
# (it rounds where the plain version rounds: the triangle inequality), a
# guard against a few wrong elements that an RMS would dilute.
FUSED_BF16_SPREAD_X = 2.0
# geometry MLP widths other than configs/vanerf.json's (ops/fused_mlp.py::
# BF16_DIMS): kernels 11 / 12 in bfloat16 take the mma.sync body there
# (phases 2b and 10f)
BF16_OTHER_WIDTHS = {"n_dims1": [9, 96, 96, 80, 64],
                     "n_dims2": [128, 48, 48, 2]}
# phase 3h: rounds of the bfloat16 frames (each in turns with the float32
# frame under the same switches), and the card's bfloat16 patch against
# the CPU port's, all on the CPU's encode and the CPU bfloat16 patch's fine
# depths: each element within 2 S + phase
# 4's tolerance, S the largest |bfloat16 - float32| of the CPU port's
# patch, and the RMS error at most S_rms / 2 + 2 E_rms, S_rms the RMS of
# that spread and E_rms of the card's float32 patch against the CPU's
# (nearer the CPU's bfloat16 patch than its float32 one; the card's
# float32 patch, the control, must fail it where bfloat16 moves the
# output).  tests/test_torch_bf16.py derives the same bounds against the
# JAX package.
BF16_ROUNDS = 3
BF16_CPU_RAYS = 8
# phase 6: card vs CPU.  The gradients sum in other orders on the two
# devices (cuDNN against CPU convolutions, atomics in index_add_ and the
# scatter backward of the plain gathers): the G loss to rtol 1e-4, and
# each parameter's gradient g to ||g_card - g_cpu|| <= 1e-3 ||g_cpu|| +
# 1e-6 ||all gradients||.  The second term covers gradients that are tiny
# next to the whole, where terms that cancel keep their rounding (the
# LayerNorm biases of the global-context convs, ~1e-5 of the total) and
# the structurally zero ones (conv biases in front of instance norms).
CARD_CPU_LOSS_RTOL = 1e-4
CARD_CPU_GRAD_RTOL = 1e-3
CARD_CPU_GRAD_ATOL = 1e-6
# phase 6 in bfloat16: the tensors that hold at least this share of the
# gradients' norm are held to S / 2 + 2 E (tests/test_torch_bf16_train.py
# takes the same share; below it sit the texture encoder's conv biases in
# front of instance norms, whose gradients are rounding noise)
BF16_GRAD_SHARE = 1e-3


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one fn() call: ``reps`` calls captured in one CUDA
    graph and replayed twice between CUDA events, so the host's dispatch
    of each call, which at a few microseconds of device work is what
    ``cuda_ms`` times, is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (2 * reps)
    del graph
    return ms


def least_time(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the f32
    rate, whichever is larger."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=n_bytes, bound_ops=n_ops)


def issue_bound_ms(n_ops: float) -> float:
    """The same operations at the issue rate of separately rounded f32
    operations (``ISSUE_OPS_PER_S``)."""
    return n_ops / ISSUE_OPS_PER_S * 1e3


def ptxas_report(log: str, pattern: str) -> dict:
    """What ``nvcc -Xptxas -v`` reported for the functions whose (mangled)
    names contain ``pattern``: {name: registers and static shared memory
    bytes (entry functions), stack frame and spill bytes}; empty when this
    run built nothing."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return {k: v for k, v in out.items() if pattern in k}


def ptxas_summary(rep: dict) -> dict:
    """The largest registers, spills and stack frame over the functions of
    a ``ptxas_report``, and how many there were (None where this run built
    nothing)."""
    def most(key):
        return max((v.get(key, 0) for v in rep.values()), default=None)
    return dict(registers=most("registers"), smem=most("smem"),
                spill_stores=most("spill_stores"),
                spill_loads=most("spill_loads"), stack=most("stack"),
                functions=len(rep))


def fused_ptxas(log: str, entry: str, bf16: bool, mma: bool = False) -> dict:
    """``ptxas_report`` of a fused kernel's entry function and the
    functions it calls: csrc/fused_mlp.cu's layer functions (fm_layer_t,
    fm_layer0_t) in its float32 instantiation (BF = false, ``Lb0E`` in the
    mangled names) or, with ``mma``, its bfloat16 one (``Lb1E``), or the
    wgmma body's (csrc/fused_mlp_bf16.cu: ``fw_query_kernel`` /
    ``fw_geo_kernel`` and the activations' plain fallbacks)."""
    if bf16 and not mma:
        return {**ptxas_report(log, entry), **ptxas_report(log, "_acc")}
    rep = {**ptxas_report(log, entry), **ptxas_report(log, "fm_layer")}
    return {k: v for k, v in rep.items() if ("Lb1E" if mma else "Lb0E") in k}


def ptxas_text(summary: dict):
    return summary if summary["functions"] else "not compiled in this run"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def of_bound(got, want, rtol: float, atol: float) -> float:
    """Largest |got - want| as a share of atol + rtol |want|."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


class env:
    """Environment switches for the length of a ``with`` block."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins at main-path shapes
# ---------------------------------------------------------------------------

def main_path_points(model, batch, grids=None):
    """The coarse-pass points of one 64x64 patch (mask-centred unless
    ``grids`` is given), plus the per-frame vertex visibility, mesh table
    and the projected (x, y) the sampler sees."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.ops import mesh_query
    if grids is None:
        gen = torch.Generator().manual_seed(SEED)
        grids = tr.mask_centered_grid(gen, batch["tar_mask"][..., 0], PATCH,
                                      PATCH)
    feat_geo, _feat_tex, vert_vis = tr.encode_frame(model, batch)
    cam_pos, cam_rays, z = tr.patch_rays(batch, grids, S_C)
    pts = (cam_pos[:, :, None] + cam_rays[:, :, None] * z[..., None])
    pts = pts.reshape(-1, 3).contiguous()
    mesh = mesh_query.prepare_culled_mesh(batch["verts"][0], batch["faces"],
                                          vert_vis[0])
    krt = batch["src_krt"][0]
    vh = pts @ krt[:3, :3].T + krt[:3, 3]
    xy = vh[:, :2] / vh[:, 2:3]
    uv = torch.stack([2.0 * xy[:, 0] / (W - 1.0) - 1.0,
                      2.0 * xy[:, 1] / (H - 1.0) - 1.0], -1).contiguous()
    return pts, mesh, feat_geo[0][0].contiguous(), uv, grids, vert_vis[0]


def ray_edge_margin(points, table):
    """How close each point's winding ray comes to an edge of a face it
    crosses or nearly crosses: the least |barycentric coordinate| of the
    crossing, in float64, over kernel A's table."""
    import torch
    t, p = table.double(), points.double()
    q = p[:, None, :] - t[None, :, 0:3]
    det = t[:, 21]
    u = (q * t[None, :, 12:15]).sum(-1) / det
    v = (q * t[None, :, 15:18]).sum(-1) / det
    edge = torch.stack([u, v, 1.0 - u - v], -1)
    near = (edge > -GRAZE_MARGIN).all(-1)
    margin = torch.where(near, edge.abs().amin(-1),
                         torch.full_like(u, float("inf")))
    return margin.amin(-1)


def fused_main_path_inputs(model, batch, grids):
    """The arguments the model's level-1 and level-2 branches hand to
    kernels 12, 11 and 10 on the coarse pass of the main-path patch: the
    entry points are wrapped for the length of two eval renders and their
    first call's arguments kept."""
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.models import vanerf as mv
    from vanerf_tpu_torch.ops import knn
    got, undo = {}, []
    for mod, name in ((mv, "fused_geo_mlp"), (mv, "fused_query_mlp"),
                      (knn, "mxu_row_gather")):
        real = getattr(mod, name)

        def wrapper(*a, _name=name, _real=real, **k):
            got.setdefault(_name, (a, k))
            return _real(*a, **k)
        setattr(mod, name, wrapper)
        undo.append((mod, name, real))
    try:
        for level in ("1", "2"):
            with env(VANERF_FUSED_MLP=level):
                tr.render_patch(model, batch, grids=grids, out_h=PATCH,
                                out_w=PATCH, sample_per_ray_c=S_C,
                                sample_per_ray_f=S_F, compute_vis_map=False)
    finally:
        for mod, name, real in undo:
            setattr(mod, name, real)
    return got


def knn_visit_margin(pts, verts, visits, visits_plain) -> float:
    """0.0 when kernel 9 visited what ``knn_cull_lists`` lists.  Else, over
    the tiles whose counts differ, how close (relative, float64) the nearest
    chunk's lower bound lies to the visit threshold: a count may differ only
    where a chunk sits on the threshold to within rounding."""
    import torch
    from vanerf_tpu_torch.ops import knn
    differ = (visits != visits_plain).nonzero()[:, 0]
    if differ.numel() == 0:
        return 0.0
    tiles = knn._edge_tiles(pts, knn.CULL_TILE_P)[differ].double()
    tmin, tmax = tiles.amin(1), tiles.amax(1)
    b = knn.vertex_chunk_boxes(verts).double()
    cmin, cmax, ccen, crad = b[:, 0:3], b[:, 3:6], b[:, 6:9], b[:, 9]
    far = torch.maximum((ccen[None] - tmin[:, None]).abs(),
                        (ccen[None] - tmax[:, None]).abs())
    ub = ((far.pow(2).sum(-1).sqrt() + crad[None]).amin(1)) ** 2
    gap = torch.clamp_min(torch.maximum(cmin[None] - tmax[:, None],
                                        tmin[:, None] - cmax[None]), 0.0)
    lb = gap.pow(2).sum(-1)
    thr = ub[:, None] * (1.0 + 1e-5) + 1e-12
    return ((lb - thr).abs() / thr).amin(1).max().item()


def mano_hands_mesh():
    """The two synthetic MANO hands, posed and sealed (right, then left):
    (1558, 3) vertices and their int32 faces, numpy."""
    import numpy as np
    from vanerf_tpu_torch.mano import mano_forward_np, seal_verts_np
    from vanerf_tpu_torch.mano.layer import synthetic_mano_model
    rs = np.random.RandomState(SEED)
    hands, faces, off = [], [], 0
    for is_rhand, hand, x in ((True, "right", 0.045), (False, "left", -0.045)):
        model = synthetic_mano_model(is_rhand)
        verts, _ = mano_forward_np(model, rs.randn(10) * 0.5,
                                   rs.randn(48) * 0.3, [x, 0.2 * x, 0.0])
        v, f = seal_verts_np(verts, model.faces, hand)
        hands.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(hands), np.concatenate(faces).astype(np.int32)


def mano_hands(dev):
    """The two synthetic MANO hands, posed and sealed: (1558, 3) on
    ``dev``."""
    import torch
    return torch.as_tensor(mano_hands_mesh()[0], dtype=torch.float32,
                           device=dev).contiguous()


def knn_culled_mano(pts, dev) -> dict:
    """Kernel 9 in both layouts against B (and 8) on the MANO-ordered
    hands: bit-equal; its visit share; times in turns, called and from a
    CUDA graph."""
    import torch
    from vanerf_tpu_torch.ops import knn
    verts = mano_hands(dev)
    n_chunks = -(-verts.shape[0] // knn.VERT_CHUNK)
    i_b, d_b = knn.nearest_vertex_d2(pts, verts)
    out = {"vertices": verts.shape[0], "chunks": n_chunks}
    pts_T = pts.t().contiguous()
    for name, fn, fn_p, q, brute in (
            ("knn_culled", knn.nearest_vertex_d2_culled,
             knn.nearest_vertex_d2_culled_plain, pts, knn.nearest_vertex_d2),
            ("knn_T_culled", knn.nearest_vertex_d2_T_culled,
             knn.nearest_vertex_d2_T_culled_plain, pts_T,
             knn.nearest_vertex_d2_T)):
        i9, d9, v9 = fn(q, verts, visits=True)
        i_q, d_q = brute(q, verts)
        torch.cuda.synchronize()
        check(torch.equal(i9, i_b) and torch.equal(d9, d_b)
              and torch.equal(i_q, i_b) and torch.equal(d_q, d_b),
              f"{name} on the MANO-ordered hands differs from kernel B")
        t = [cuda_ms(lambda f=f: f(q, verts), 20)
             for f in (fn, brute, brute, fn)]
        out[name] = dict(
            visit_share=v9.float().mean().item() / n_chunks,
            tiles_skipping=int((v9 < n_chunks).sum()),
            ms=0.5 * (t[0] + t[3]), brute_ms=0.5 * (t[1] + t[2]),
            device_ms=graph_ms(lambda: fn(q, verts)),
            brute_device_ms=graph_ms(lambda: brute(q, verts)),
            plain_ms=cuda_ms(lambda: fn_p(q, verts), 3),
            library_ms=cuda_ms(lambda: torch.cdist(pts, verts).min(1), 3),
            **least_time(nbytes(pts, verts, i9, d9),
                         KNN_OPS * pts.shape[0] * verts.shape[0]))
    return out


def culled_query_checks(name, fn, fn_p, q, p_c, mesh, d2, tilings, far2):
    """The culled kernel A (``q`` = ``p_c``) or 7 (``q`` = its transpose)
    in every tiling, without and with the far tier, by its default walk
    and under ``VANERF_CULL_EARLY=1``."""
    import torch
    from vanerf_tpu_torch.ops import mesh_query
    N = p_c.shape[0]
    table = mesh["table"]
    F = table.shape[0]
    n_chunks = mesh["cbox"].shape[0]
    table_mesh_order = table[torch.argsort(mesh["order"])].contiguous()
    sizes = torch.full((n_chunks,), float(mesh_query.CULL_CHUNK),
                       device=p_c.device)
    sizes[-1] = F - mesh_query.CULL_CHUNK * (n_chunks - 1)
    detail, err = {}, 0.0
    for tiling, tiles in tilings.items():
        for tag, f2 in (("exact", None), ("far", far2)):
            got = fn(q, mesh, d2, tiles, f2, visits=True)
            want = fn_p(q, mesh, d2, tiles, f2, visits=True)
            torch.cuda.synchronize()
            for k, g_, w_ in zip(("d2", "idx", "wind", "qvis", "far",
                                  "visits"), got, want):
                check((g_ is None and w_ is None) or torch.equal(g_, w_),
                      f"{name} {tiling} {tag}: {k} differs from the plain "
                      "version")
                if k in ("d2", "wind", "qvis"):
                    err = max(err, (g_ - w_).abs().max().item())
            d2_c, idx_c, wind_c, qvis_c, far_c, _visits = got
            # the sweep over every face of the same sorted table
            sweep = mesh_query.point_mesh_query_vis_cuda(p_c, table, d2,
                                                         far_c)
            for k, g_, w_ in zip(("d2", "idx", "wind", "qvis"), got, sweep):
                if k != "wind":
                    check(torch.equal(g_, w_), f"{name} {tiling} {tag}: {k} "
                          "differs from the sweep over the sorted table")
            tmin, tmax, ub_t, far_t, tile_of = mesh_query.tile_boxes(
                p_c, d2, tiles, f2)
            mask, use_neg, _lb = mesh_query.cull_masks(tmin, tmax, ub_t,
                                                       mesh["cbox"], far_t)
            differ = wind_c != sweep[2]
            check(not (differ & ~use_neg[tile_of]).any().item(),
                  f"{name} {tiling} {tag}: the winding differs from the "
                  "sweep's on a tile that keeps +d")
            n_differ = int(differ.sum())
            graze = (ray_edge_margin(p_c[differ], table).max().item()
                     if n_differ else 0.0)
            check(n_differ <= GRAZE_SHARE * N and graze <= GRAZE_MARGIN,
                  f"{name} {tiling} {tag}: {n_differ} crossing counts along "
                  f"-d differ from the sweep's, the farthest {graze:.3g} "
                  "(barycentric units) from an edge")
            # the sweep over the table in mesh order (the kernel before the
            # sort): d2 to the bit; the visibility wherever the same face
            # wins (else an exact tie: the distances are equal)
            before = mesh_query.point_mesh_query_vis_cuda(
                p_c, table_mesh_order, d2, far_c)
            check(torch.equal(d2_c, before[0]), f"{name} {tiling} {tag}: d2 "
                  "differs from the sweep over the table in mesh order")
            same_face = mesh["order"][idx_c.long()] == before[1]
            if far_c is not None:
                same_face |= far_c              # far points read no face
            check(torch.equal(qvis_c[same_face], before[3][same_face]),
                  f"{name} {tiling} {tag}: qvis differs off a tie")
            # the early-exit walk: equal to its plain version; d2 and the
            # winding equal to the default walk's; another face only where
            # its distance is the same d2 (a tie)
            with env(VANERF_CULL_EARLY="1"):
                got_e = fn(q, mesh, d2, tiles, f2, visits=True)
                want_e = fn_p(q, mesh, d2, tiles, f2, visits=True)
                torch.cuda.synchronize()
                for k, g_, w_ in zip(("d2", "idx", "wind", "qvis", "far",
                                      "visits"), got_e, want_e):
                    check((g_ is None and w_ is None) or torch.equal(g_, w_),
                          f"{name} {tiling} {tag} early exit: {k} differs "
                          "from the plain version")
                e_ms = [cuda_ms(lambda: fn(q, mesh, d2, tiles, f2), 5)]
            check(torch.equal(got_e[0], d2_c) and torch.equal(got_e[2], wind_c),
                  f"{name} {tiling} {tag} early exit: d2 or the winding "
                  "differs from the default walk's")
            moved = got_e[1] != idx_c
            rows = table[got_e[1][moved].long()]
            at = mesh_query.point_triangle_sq_dist(
                p_c[moved], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
            check(torch.equal(at, d2_c[moved]), f"{name} {tiling} {tag} early "
                  "exit: another face off a tie")
            # in turns: culled, sweep, early, early, sweep, culled
            t1 = cuda_ms(lambda: fn(q, mesh, d2, tiles, f2), 5)
            s1 = cuda_ms(lambda: mesh_query.point_mesh_query_vis_cuda(
                p_c, table, d2, far_c), 5)
            with env(VANERF_CULL_EARLY="1"):
                e_ms.append(cuda_ms(lambda: fn(q, mesh, d2, tiles, f2), 5))
            s2 = cuda_ms(lambda: mesh_query.point_mesh_query_vis_cuda(
                p_c, table, d2, far_c), 5)
            t2 = cuda_ms(lambda: fn(q, mesh, d2, tiles, f2), 5)
            dist_pairs = (((mask & 1).float() @ sizes).sum().item()
                          * mesh_query.TILE_P)
            wind_pairs = (((mask >> 1).float() @ sizes).sum().item()
                          * mesh_query.TILE_P)
            detail[f"{tiling}_{tag}"] = dict(
                ms=0.5 * (t1 + t2), sweep_ms=0.5 * (s1 + s2),
                early_ms=0.5 * sum(e_ms),
                early_ties=int(moved.sum()),
                dist_visit_share=(mask & 1).float().mean().item(),
                wind_visit_share=(mask >> 1).float().mean().item(),
                neg_tile_share=use_neg.float().mean().item(),
                far_tile_share=(far_t.float().mean().item()
                                if far_t is not None else 0.0),
                wind_differs_from_sweep=n_differ, their_edge_margin=graze,
                tied_faces=int((~same_face).sum()),
                dist_pairs=dist_pairs, wind_pairs=wind_pairs,
                out=dict(d2=d2_c, idx=idx_c, wind=wind_c, qvis=qvis_c),
                far=far_c, bytes=nbytes(q, table, mesh["cbox"],
                                        mesh["sphere"], d2, *[
                    t for t in got[:5] if t is not None]))
    main = detail["1d_far"]
    out, far = main["out"], main["far"]
    for d in detail.values():
        d.pop("out")
        d.pop("far")
    tiles = tilings["1d"]
    n_far = int(far.sum())
    ops = main["dist_pairs"] * MESH_DIST_OPS + main["wind_pairs"] * \
        MESH_CROSS_OPS
    # what the kernel evaluates: a sphere test for every visited pair, the
    # full distance only where a warp keeps the face
    work = mesh_query.culled_work(p_c, mesh, d2, tiles, far2)
    work_ops = (work["sphere_tests"] * MESH_SPHERE_OPS
                + work["evaluated"] * MESH_DIST_OPS
                + work["crossings"] * MESH_CROSS_OPS)
    return dict(
        shape=f"{N} points x {F} faces in {n_chunks} chunks, 16-ray x "
              f"8-sample tiles, {main['far_tile_share']:.3f} of them far, "
              f"{main['dist_visit_share']:.3f} / "
              f"{main['wind_visit_share']:.3f} of the (tile, chunk) pairs "
              "visited for the distance / the winding",
        max_abs_err=err, detail=detail, out=out, far=far,
        ms=main["ms"], brute_ms=main["sweep_ms"],
        device_ms=graph_ms(lambda: fn(q, mesh, d2, tiles, far2)),
        early_ms=main["early_ms"],
        # the same launch with the far tier off: what the far tier saves
        exact_ms=detail["1d_exact"]["ms"],
        plain_ms=cuda_ms(lambda: fn_p(q, mesh, d2, tiles, far2), 2),
        library_ms=None,
        # every pair, as the sweep with per-point far flags visits them: far
        # points skip the distance search and keep the crossing test
        all_pairs=least_time(main["bytes"], F * (
            (N - n_far) * (MESH_DIST_OPS + MESH_CROSS_OPS)
            + n_far * MESH_CROSS_OPS)),
        issue_bound_ms=issue_bound_ms(ops),
        work=work, work_issue_bound_ms=issue_bound_ms(work_ops),
        **least_time(main["bytes"], ops))


def culled_size_checks(p_c, batch, vert_vis, d2, far2):
    """Kernel A at every tile and chunk size it is built for
    (``VANERF_MESH_TILE_P`` x ``VANERF_CULL_CHUNK``, 16-ray blocks scaled to
    the tile), far tier on: equal to its plain version, d2 / idx / qvis to
    the sweep over the same table; timed as called."""
    import torch
    from vanerf_tpu_torch.ops import mesh_query
    out = {}
    for tile_p in mesh_query.TILE_SIZES:
        for chunk in mesh_query.CHUNK_SIZES:
            with env(VANERF_MESH_TILE_P=str(tile_p),
                     VANERF_CULL_CHUNK=str(chunk),
                     VANERF_BLOCK_RAYS=str(tile_p // 8)):
                mesh = mesh_query.prepare_culled_mesh(
                    batch["verts"][0], batch["faces"], vert_vis)
                q = p_c            # every preparation centres alike
                tiles = mesh_query.tile_geometry(q.shape[0], S_C)
                got = mesh_query.point_mesh_query_vis_culled(q, mesh, d2,
                                                             tiles, far2)
                want = mesh_query.point_mesh_query_vis_culled_plain(
                    q, mesh, d2, tiles, far2)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"mesh_query tile {tile_p} chunk {chunk}: differs from "
                      "the plain version")
                sweep = mesh_query.point_mesh_query_vis_cuda(
                    q, mesh["table"], d2, got[4])
                check(all(torch.equal(got[k], sweep[k]) for k in (0, 1, 3)),
                      f"mesh_query tile {tile_p} chunk {chunk}: differs from "
                      "the sweep")
                out[f"tile{tile_p}_chunk{chunk}"] = cuda_ms(
                    lambda: mesh_query.point_mesh_query_vis_culled(
                        q, mesh, d2, tiles, far2), 5)
    return out


def packed_faces_np(xy, z, faces):
    """Kernel C's packed (F, 9) rows [ax ay az bx by bz cx cy cz] in
    numpy (``ops/rasterize.py::_packed_faces``)."""
    import numpy as np
    f = np.asarray(faces).astype(np.int64)
    return np.concatenate([xy[f], z[f][..., None]], -1).reshape(-1, 9) \
        .astype(np.float32)


RASTER_CASES = (
    "the frame's vertex visibility, 256^2", "vertex visibility at 64^2",
    "250x250, no multiple of the tile",
    "the train step's target view (render_vis_map)",
    "a distant mesh in one tile", "faces off the raster on every side",
    "slivers and degenerate faces",
    "vertices on pixel centres, shared edges, equal depths",
    "large and non-finite coordinates")


def raster_cases(b):
    """Kernel C's cases beside the main path's source-view raster, from a
    numpy fixture batch (index 0): (tag, packed faces (F, 9) float32, H,
    W).  The rasters the port makes (the frame's vertex visibility at
    256^2 and at the CPU tests' 64^2, the train step's target-view
    ``render_vis_map``) and the places a tile's face culling could go
    wrong: a distant mesh whose every face falls in one tile, faces off the
    raster on every side, slivers and degenerate faces, vertices on pixel
    centres with shared edges and equal depths (ties), a raster that is no
    multiple of the tile, coordinates too large for the certificate and
    non-finite ones."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    verts = b["verts"][0].astype(np.float32)
    faces = np.asarray(b["faces"]).astype(np.int64)
    krt = b["src_krt"][0]
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    xy = vh[:, :2] / (vh[:, 2:3] + 1e-8)
    xy01 = xy / np.float32(W - 1.0)
    z01 = ((vh[:, 2] - b["znear"]) / (b["zfar"] - b["znear"])) \
        .astype(np.float32)
    K, Rt = b["tar_k"][0], b["tar_rt"][0]
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    uv = np.stack([cam[:, 0] / (cam[:, 2] + 1e-8) * K[0, 0] + K[0, 2],
                   cam[:, 1] / (cam[:, 2] + 1e-8) * K[1, 1] + K[1, 2]], -1)
    lo, hi = xy01.min(0), xy01.max(0)
    unit = (xy01 - lo) / (hi - lo)
    pack = packed_faces_np
    cases = [
        ("the frame's vertex visibility, 256^2", pack(xy01 * 255.0, z01,
                                                      faces), 256, 256),
        ("vertex visibility at 64^2", pack(xy01 * 63.0, z01, faces), 64, 64),
        ("250x250, no multiple of the tile", pack(xy01 * 249.0, z01, faces),
         250, 250),
        ("the train step's target view (render_vis_map)",
         pack(uv.astype(np.float32), cam[:, 2], faces), H, W),
        ("a distant mesh in one tile", pack(96.5 + unit * 14.0, z01, faces),
         256, 256)]
    part = faces[::4]
    off = np.concatenate([
        pack(xy + shift, vh[:, 2], part) for shift in (
            [-180.0, 0.0], [0.0, 200.0], [-700.0, -650.0], [300.0, 0.0],
            [0.0, -240.0])])
    cases.append(("faces off the raster on every side", off, 256, 256))
    # slivers: near-collinear corners, zero area, repeated corners, long
    # thin faces across many tiles, among ordinary faces
    n = 600
    a = rs.rand(n, 2) * 70.0 - 3.0
    d = rs.randn(n, 2) * 8.0
    t = rs.rand(n, 1)
    kind = rs.randint(0, 5, n)[:, None]
    perp = np.stack([-d[:, 1], d[:, 0]], -1)
    c = np.where(kind == 0, a + t * d,                     # collinear
                 np.where(kind == 1, a + t * d + perp * 1e-7,
                          np.where(kind == 2, a,          # repeated corner
                                   a + rs.randn(n, 2) * 6.0)))
    bb = np.where(kind == 3, a + d * 9.0, a + d)          # long slivers
    c = np.where(kind == 3, a + d * 4.5 + perp * 1e-4, c)
    tri = np.concatenate([a, rs.rand(n, 1), bb, rs.rand(n, 1), c,
                          rs.rand(n, 1)], 1)
    cases.append(("slivers and degenerate faces", tri.astype(np.float32),
                  64, 64))
    # a grid of 4x4-pixel quads on pixel centres, each split in two, in
    # three layers: a copy at the same depth (ties) and one in front on
    # half the quads
    gy, gx = np.meshgrid(np.arange(0, 60, 4), np.arange(0, 60, 4),
                         indexing="ij")
    q = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64)
    sq = [np.concatenate([q, q + [4, 0], q + [4, 4]], 1),
          np.concatenate([q, q + [4, 4], q + [0, 4]], 1)]
    base = np.concatenate(sq)
    layer = []
    for zval, keep in ((0.5, slice(None)), (0.5, slice(None)),
                       (0.25, slice(0, None, 2))):
        f = base[keep]
        zz = np.full((f.shape[0], 1), zval)
        layer.append(np.concatenate([f[:, 0:2], zz, f[:, 2:4], zz, f[:, 4:6],
                                     zz], 1))
    cases.append(("vertices on pixel centres, shared edges, equal depths",
                  np.concatenate(layer).astype(np.float32), 61, 59))
    big = pack(xy01 * 255.0, z01, faces)[:64].copy()
    big[0:8, [0, 3, 6]] *= 1e19                 # beyond the certified 2^60
    big[8:16, [1, 4, 7]] += 2.0 ** 59
    big[16, 0], big[17, 4], big[18, 7] = np.inf, -np.inf, np.nan
    big[19, 2], big[20, 5], big[21, 8] = np.inf, -np.inf, np.nan
    cases.append(("large and non-finite coordinates",
                  np.concatenate([big, pack(xy01 * 255.0, z01, faces)]),
                  256, 256))
    assert tuple(c[0] for c in cases) == RASTER_CASES
    return cases


def offset_view(x, shift: int):
    """A contiguous copy of ``x`` whose data starts ``shift`` elements into
    its storage: a float4 (float2) load of it is misaligned for shift % 4
    (shift % 2)."""
    import torch
    flat = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    view = flat[shift:].view(x.shape)
    view.copy_(x)
    return view


def interp_cases(geo_coarse, uv, dev):
    """Kernel D's cases: (tag, summed in the kernels line?, map, points).
    The main path samples the 32^2 x 64 geometry coarse map at the patch's
    projected points, one launch a pass (the 128^2 x 8 fine geometry map is
    too large for D and the 64^2 x 8 texture map is not sampled through
    it); the kernels line sums it with a 64^2 x 16 map (4,096 pixels, the
    largest D takes) at the same points, as it has since D was ported.  The
    other cases: the scalar-lane instantiation (6 channels, a table or a uv
    that starts off a 16- / 8-byte boundary), a slice of a batch, points
    beyond [-1, 1] and counts that fill no whole block."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED)
    m64 = torch.randn(64, 64, 16, generator=g, device=dev)
    batch = torch.randn(2, 32, 32, 64, generator=g, device=dev)
    wide = (uv * 1.3).contiguous()
    return [("32^2x64", True, geo_coarse, uv),
            ("64^2x16, the largest map", True, m64, uv),
            ("16^2x6, scalar lanes", False,
             torch.randn(16, 16, 6, generator=g, device=dev), wide[:5001]),
            ("32^2x64 slice feat[1] of a batch, uv beyond [-1, 1]", False,
             batch[1], wide[:5001]),
            ("32^2x64 table off 16 bytes", False, offset_view(geo_coarse, 1),
             uv[:4999].contiguous()),
            ("64^2x16, uv off 8 bytes", False, m64,
             offset_view(wide[:777], 1))]


def lanes_launched(fn, kernel: str, vector: str = "float4") -> str:
    """Which instantiation of the CUDA kernel ``kernel`` fn() launches, as
    torch.profiler names it: ``kernel<true...>`` is the vector one
    (``vector`` names it), the C entry point's choice.  A short session may
    end before the device's records arrive: up to 5 are tried."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if kernel + "<true" in e.key:
                return vector
            if kernel + "<false" in e.key:
                return "scalar"
    return "not seen by the profiler"


def interp_case(case):
    """One case of kernel D against its plain version and F.grid_sample:
    ``ms`` / ``library_ms`` as called (CUDA events over 20 calls),
    ``device_ms`` / ``library_device_ms`` replayed from a CUDA graph."""
    import torch
    import torch.nn.functional as F
    from vanerf_tpu_torch.ops import interp_mxu
    _tag, _main, fm, u = case
    kname, vector = (("interp_bf16_kernel", "8-channel")
                     if fm.dtype == torch.bfloat16 else
                     ("interp_kernel", "float4"))
    got = interp_mxu.interp_cuda(fm, u)
    again = interp_mxu.interp_cuda(fm, u)
    want = interp_mxu.interp_plain(fm, u)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    check(torch.equal(got, want), f"sampler differs from its plain version "
          f"({_tag}): {err}")
    check(torch.equal(got, again), f"sampler not repeatable ({_tag})")
    nchw = fm.permute(2, 0, 1)[None].contiguous()
    # F.grid_sample takes the grid in the map's dtype: on a bfloat16 map
    # its coordinates round to bfloat16, the nearest one PyTorch call comes
    grid = u.to(fm.dtype)[None, None]
    Hm, Wm, C = fm.shape

    def library():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return dict(
        shape=f"{u.shape[0]} points on {Hm}x{Wm}x{C}",
        lanes=lanes_launched(lambda: interp_mxu.interp_cuda(fm, u), kname,
                             vector),
        max_abs_err=err, bit_equal_runs=True,
        ms=cuda_ms(lambda: interp_mxu.interp_cuda(fm, u), 20),
        device_ms=graph_ms(lambda: interp_mxu.interp_cuda(fm, u)),
        plain_ms=cuda_ms(lambda: interp_mxu.interp_plain(fm, u), 5),
        library_ms=cuda_ms(library, 20),
        library_device_ms=graph_ms(library),
        # per point ~20 for the weights, per output 4 products and 3 sums
        **least_time(nbytes(fm, u, got), u.shape[0] * (20 + 7 * C)))


def bilinear_cases(model, batch, uv, dev):
    """Kernel 14's cases: (tag, summed in the kernels line?, maps, points).
    The main path samples three maps through ``feat_sample_nhwc`` at the
    patch's projected points, one launch each a pass: the 256^2 x 4 mask +
    image, the 128^2 x 8 fine geometry map (above kernel D's 4,096 rows)
    and the 64^2 x 8 texture map (its shape differs from the fine map's);
    the kernels line sums them at one tile's 262,144 points.  Then the
    serving launches (the 16 tiles of a group on one map; two source views:
    32 element-views on two maps), a 64^2 x 16 map, the bfloat16 maps and
    the scalar-lane cases (3 channels, a map or points off their
    alignment, a count that fills no whole block)."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    feat_geo, feat_tex, _vis = tr.encode_frame(model, batch)
    maps = {"256^2x4 mask + image": torch.cat(
                [batch["src_mask"], batch["src_img"]], -1)[:1],
            "128^2x8 fine geometry": feat_geo[1][:1],
            "64^2x8 texture": feat_tex[:1]}
    maps = {k: v.float().contiguous() for k, v in maps.items()}
    u1 = uv[None].contiguous()
    u16 = uv[None].expand(16, -1, -1).contiguous()
    u32 = uv[None].expand(32, -1, -1).contiguous()
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(k, True, m, u1) for k, m in maps.items()]
    cases += [(k + ", a 16-tile group", False, m, u16)
              for k, m in maps.items()]
    cases += [(k + ", two views x 16 tiles", False,
               torch.cat([m, m.flip(1)]).contiguous(), u32)
              for k, m in maps.items()]
    cases.append(("64^2x16", False,
                  torch.randn(1, 64, 64, 16, generator=g, device=dev), u1))
    cases += [(k + ", bfloat16, a 16-tile group", False,
               m.to(torch.bfloat16), u16) for k, m in maps.items()]
    wide = (u1 * 1.3).contiguous()
    m3 = torch.randn(2, 64, 64, 3, generator=g, device=dev)
    fine = maps["128^2x8 fine geometry"]
    cases += [("64^2x3, scalar lanes, Bm 2, uv beyond [-1, 1]", False, m3,
               torch.cat([wide, wide])[:, :5001].contiguous()),
              ("128^2x8 map off 16 bytes", False, offset_view(fine, 1),
               u1[:, :4999].contiguous()),
              ("128^2x8, uv off 8 bytes", False, fine,
               offset_view(wide[:, :777].contiguous(), 1))]
    return cases


def units_launched(fn, kernel: str) -> str:
    """The template arguments of the instantiation of ``kernel`` that fn()
    launches, as torch.profiler names it (up to 5 sessions are tried)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            at = e.key.find(kernel + "<")
            if at >= 0:
                return e.key[at + len(kernel):e.key.find(">", at) + 1]
    return "not seen by the profiler"


def bilinear_case(case):
    """One case of kernel 14 against feat_sample_nhwc_plain and
    F.grid_sample (the yardstick: the port never calls it): ``ms`` /
    ``library_ms`` as called (CUDA events over 20 calls), ``device_ms`` /
    ``library_device_ms`` replayed from a CUDA graph."""
    import torch
    import torch.nn.functional as F
    from vanerf_tpu_torch.ops import grid_sample as gs
    from vanerf_tpu_torch.ops._cuda import batch_index
    _tag, _main, fm, u = case
    got = gs.bilinear_cuda(fm, u)
    again = gs.bilinear_cuda(fm, u)
    want = gs.feat_sample_nhwc_plain(fm, u)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"kernel 14 differs from the plain "
          f"version ({_tag}): {err}")
    check(torch.equal(got, again), f"kernel 14 not repeatable ({_tag})")
    Bm, Hm, Wm, C = fm.shape
    B, N = u.shape[:2]
    nchw = fm.permute(0, 3, 1, 2)[batch_index(B, Bm, fm.device)].contiguous()
    grid = u.to(fm.dtype)[:, None]

    def library():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return dict(
        shape=f"{B} x {N} points on {Bm} x {Hm}x{Wm}x{C} {fm.dtype}"
              .replace("torch.", ""),
        lanes=units_launched(lambda: gs.bilinear_cuda(fm, u),
                             "bilinear_kernel"),
        max_abs_err=err, bit_equal_runs=True,
        ms=cuda_ms(lambda: gs.bilinear_cuda(fm, u), 20),
        device_ms=graph_ms(lambda: gs.bilinear_cuda(fm, u)),
        plain_ms=cuda_ms(lambda: gs.feat_sample_nhwc_plain(fm, u), 5),
        library_ms=cuda_ms(library, 20),
        library_device_ms=graph_ms(library),
        # per point ~20 for the coordinates and weights, per output 6
        # products and 3 sums
        **least_time(nbytes(fm, u, got), B * N * (20 + 9 * C)))


def texel(uv_, hw: int):
    """The flat texel index of each point on an hw x hw map."""
    import torch
    x = ((uv_[:, 0] + 1.0) * 0.5 * (hw - 1.0)).clamp(0.0, hw - 1.0)
    y = ((uv_[:, 1] + 1.0) * 0.5 * (hw - 1.0)).clamp(0.0, hw - 1.0)
    return (torch.floor(y) * hw + torch.floor(x)).to(torch.int32)


def scatter_cases(idx, n_verts, geo_coarse, uv, v_uv, dev):
    """Kernel 13's cases: (tag, main path?, row ids, rows, channels).  The
    training path's tables: the KNN vertex table (rows = vertices, the
    packed [this | toh] rows of 2 x (72 + 29 + 1) channels) read at the
    nearest-vertex ids; the packed 32^2 x 4*64 geometry coarse map and the
    packed 64^2 x 4*8 maps read at the texel of each point; the coarse map
    read at the 1,284 projected vertices (the fusion's vertex table, the
    one-launch path).  Then the edge cases: no point, one point, both sides
    of the one-launch limit, every point on one row, scalar channels, a
    gradient that starts off a 16-byte boundary (``offset``)."""
    import torch
    from vanerf_tpu_torch.ops import onehot_gather
    Hc, lim = geo_coarse.shape[0], onehot_gather.SCATTER_SMALL_N
    tex64 = texel(uv, 64)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return [
        ("knn table", True, idx, n_verts, 2 * (72 + 29 + 1)),
        ("32^2 coarse map", True, texel(uv, Hc), Hc * Hc,
         4 * geo_coarse.shape[2]),
        ("64^2 map", True, tex64, 64 * 64, 4 * 8),
        ("32^2 coarse map at the vertices", True, texel(v_uv, Hc), Hc * Hc,
         4 * geo_coarse.shape[2]),
        ("no point", False, empty, 3, 5),
        ("one point", False, tex64[:1] % 3, 3, 5),
        (f"{lim} points, the one-launch limit", False,
         tex64[:lim].contiguous(), 64 * 64, 32),
        (f"{lim + 1} points, above it", False, tex64[:lim + 1].contiguous(),
         64 * 64, 32),
        ("every point on one row", False, torch.full_like(tex64, 4321),
         onehot_gather.SCATTER_MAX_T, 32),
        ("scalar channels", False, tex64, 64 * 64, 5),
        ("gradient off 16 bytes, offset", False, tex64, 64 * 64, 32)]


def scatter_case(case):
    """One case of kernel 13 against index_add_ into a zeroed table (its
    plain version, also the library call): ``ms`` / ``library_ms`` as
    called (CUDA events over 20 calls), ``device_ms`` /
    ``library_device_ms`` replayed from a CUDA graph."""
    import torch
    from vanerf_tpu_torch.ops import onehot_gather
    tag, _main, rows, T, C = case
    g = torch.randn(rows.shape[0], C, device=rows.device,
                    generator=torch.Generator(device=rows.device)
                    .manual_seed(SEED))
    if tag.endswith("offset"):
        g = offset_view(g, 1)
    rows = rows.contiguous()
    got = onehot_gather.onehot_scatter_cuda(g, rows, T)
    again = onehot_gather.onehot_scatter_cuda(g, rows, T)
    want = onehot_gather.onehot_scatter_plain(g, rows, T)
    bound = onehot_gather.onehot_scatter_plain(g.abs(), rows, T)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"scatter not deterministic ({tag})")
    e = (got - want).abs()
    check(bool((e <= 1e-5 * bound + 1e-30).all()),
          f"scatter err {e.max().item()} ({tag})")
    check(not got[bound.sum(1) == 0].any(), f"scatter: rows without points "
          f"are not zero ({tag})")
    n = rows.shape[0]
    small = n <= onehot_gather.SCATTER_SMALL_N
    rows_l = rows.long()
    acc = torch.zeros(T, C, device=rows.device)

    def kernel():
        return onehot_gather.onehot_scatter_cuda(g, rows, T)

    def plain():
        return onehot_gather.onehot_scatter_plain(g, rows, T)

    plain_ms = cuda_ms(plain, 20)
    return dict(
        shape=f"{n} rows into {T}x{C}",
        path="one launch" if small else "counting sort",
        lanes=lanes_launched(kernel, "os_small" if small else "os_sum"),
        max_abs_err=e.max().item() if e.numel() else 0.0,
        rel_to_abs_sum=(e / bound.clamp(min=1e-30)).max().item()
        if e.numel() else 0.0, bit_equal_runs=True,
        rows_read=int((bound > 0).any(1).sum()),
        ms=cuda_ms(kernel, 20), device_ms=graph_ms(kernel),
        plain_ms=plain_ms, library_ms=plain_ms,
        library_device_ms=graph_ms(plain),
        # index_add_ alone, into a table allocated ahead and int64 ids made
        # ahead (it accumulates across the timed calls, which changes
        # nothing it does)
        bare_library_device_ms=graph_ms(lambda: acc.index_add_(0, rows_l,
                                                               g)),
        **least_time(nbytes(g, rows, got), g.numel()))


SUMMED = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")


def kernel_cases(cases, run):
    """Run every case of a kernel; the kernel's entry sums the times and
    bounds of the cases marked for the kernels line, and keeps every case
    under ``cases``."""
    per = [(c[0], c[1], run(c)) for c in cases]
    summed = [r for _t, m, r in per if m]
    tot = least_time(sum(r["bound_bytes"] for r in summed),
                     sum(r["bound_ops"] for r in summed))
    return dict(
        shape=", ".join(r["shape"] for r in summed),
        max_abs_err=max(r["max_abs_err"] for _t, _m, r in per),
        **{k: sum(r[k] for r in summed) for k in SUMMED},
        cases={t: dict(r, summed=m) for t, m, r in per}, **tot)


def ulp_bf16(x):
    """One bfloat16 unit in the last place at |x| (8 significant bits)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def scatter_case_bf16(case):
    """One case of kernel 13's bfloat16 form, its rows drawn in float32 and
    rounded to bfloat16: the table equal to the float32 kernel on the rows
    widened to float32, rounded once to bfloat16, bit for bit (the same
    sums; that kernel meets its own gate against index_add_); within one
    bfloat16 unit of its plain version (float32 ``index_add_``, one cast);
    two runs equal.  ``library_ms``: index_add_ of the bfloat16 values
    (widened) into a zeroed float32 table plus the cast, which is the plain
    version itself."""
    import torch
    from vanerf_tpu_torch.ops import onehot_gather as og
    bf = torch.bfloat16
    tag, _main, rows, T, C = case
    rows = rows.contiguous()
    g = torch.randn(rows.shape[0], C, device=rows.device,
                    generator=torch.Generator(device=rows.device)
                    .manual_seed(SEED)).to(bf)
    got = og.onehot_scatter_cuda(g, rows, T)
    again = og.onehot_scatter_cuda(g, rows, T)
    f32 = og.onehot_scatter_cuda(g.float(), rows, T)
    want = og.onehot_scatter_plain(g, rows, T)
    want32 = og.onehot_scatter_plain(g.float(), rows, T)
    bound = og.onehot_scatter_plain(g.float().abs(), rows, T)
    torch.cuda.synchronize()
    check(got.dtype == bf, f"bfloat16 scatter returned {got.dtype} ({tag})")
    check(torch.equal(got, again), f"bfloat16 scatter not deterministic "
          f"({tag})")
    check(torch.equal(got, f32.to(bf)), f"bfloat16 scatter is not the "
          f"float32 kernel's sums rounded once ({tag})")
    e32 = (f32 - want32).abs()
    check(bool((e32 <= 1e-5 * bound + 1e-30).all()),
          f"float32 scatter on the widened rows: err {e32.max().item()} "
          f"({tag})")
    e = (got.float() - want.float()).abs()
    units = e / ulp_bf16(torch.maximum(got.float().abs(),
                                       want.float().abs()))
    check(bool((units <= 1.0).all()), f"bfloat16 scatter {units.max()} "
          f"units from its plain version ({tag})")
    small = rows.shape[0] <= og.SCATTER_SMALL_N

    def kernel():
        return og.onehot_scatter_cuda(g, rows, T)

    def plain():
        return og.onehot_scatter_plain(g, rows, T)

    plain_ms = cuda_ms(plain, 20)
    return dict(
        shape=f"{rows.shape[0]} bfloat16 rows into {T}x{C}",
        path="one launch" if small else "counting sort",
        lanes=lanes_launched(kernel, "os_small" if small else "os_sum",
                             "4 x bfloat16"),
        max_abs_err=e.max().item() if e.numel() else 0.0,
        max_units=units.max().item() if e.numel() else 0.0,
        share_rounded_apart=(e > 0).float().mean().item()
        if e.numel() else 0.0,
        equal_to_f32_kernel_rounded=True, bit_equal_runs=True,
        ms=cuda_ms(kernel, 20), device_ms=graph_ms(kernel),
        plain_ms=plain_ms, library_ms=plain_ms,
        library_device_ms=graph_ms(plain),
        **least_time(nbytes(g, rows, got), g.numel()))


def phase_kernels(model, batch, dev):
    import torch
    from vanerf_tpu_torch.ops import (_cuda, fused_mlp, interp_mxu, knn,
                                      mesh_query, onehot_gather, rasterize)
    results = {}
    pts, mesh, geo_coarse, uv, grids, vert_vis = main_path_points(model,
                                                                  batch)
    verts = batch["verts"][0].contiguous()
    check(pts.shape[0] == PATCH * PATCH * S_C, "main-path point count")

    # --- B: nearest vertex ---
    idx, d2 = knn.nearest_vertex_d2(pts, verts)
    idx_p, d2_p = knn.nearest_vertex_d2_plain(pts, verts)
    torch.cuda.synchronize()
    err_b = (d2 - d2_p).abs().max().item()
    check(err_b <= 1e-6 * d2_p.abs().max().item(), f"knn d2 err {err_b}")
    diff = idx.long() != idx_p.long()
    if diff.any():       # an index may differ only on an exact d2 tie
        alt = ((pts[diff] - verts[idx[diff].long()]) ** 2).sum(-1)
        check(torch.allclose(alt, d2_p[diff], rtol=1e-6, atol=0),
              "knn index differs off a tie")
    check(torch.equal(idx, idx_p) and torch.equal(d2, d2_p),
          "knn differs from its plain version")
    results["knn"] = dict(
        shape=f"{pts.shape[0]} points x {verts.shape[0]} vertices",
        max_abs_err=err_b, index_mismatch=int(diff.sum()),
        ms=cuda_ms(lambda: knn.nearest_vertex_d2(pts, verts), 20),
        device_ms=graph_ms(lambda: knn.nearest_vertex_d2(pts, verts)),
        issue_bound_ms=issue_bound_ms(
            KNN_OPS * pts.shape[0] * verts.shape[0]),
        plain_ms=cuda_ms(lambda: knn.nearest_vertex_d2_plain(pts, verts), 3),
        # one call each for distances and argmin; cdist may take the
        # expanded |q|^2 - 2 q.v + |v|^2 form, which is other arithmetic
        library_ms=cuda_ms(lambda: torch.cdist(pts, verts).min(1), 3),
        **least_time(nbytes(pts, verts, idx, d2),
                     KNN_OPS * pts.shape[0] * verts.shape[0]))

    # --- 9: the landmark-culled search, (N, 3) and (3, N): equal to B / 8
    # bit for bit, the visits those of knn_cull_lists ---
    pts_T = pts.t().contiguous()
    n_pairs_knn = pts.shape[0] * verts.shape[0]
    order_v = mesh_query._morton_order(verts)
    order_p = mesh_query._morton_order(pts)
    verts_s = verts[order_v].contiguous()
    for name, fn, fn_p, q, brute in (
            ("knn_culled", knn.nearest_vertex_d2_culled,
             knn.nearest_vertex_d2_culled_plain, pts, knn.nearest_vertex_d2),
            ("knn_T_culled", knn.nearest_vertex_d2_T_culled,
             knn.nearest_vertex_d2_T_culled_plain, pts_T,
             knn.nearest_vertex_d2_T)):
        i9, d9, v9 = fn(q, verts, visits=True)
        i9_p, d9_p, v9_p = fn_p(q, verts, visits=True)
        i_b, d_b = brute(q, verts)
        torch.cuda.synchronize()
        check(torch.equal(i9, idx) and torch.equal(d9, d2)
              and torch.equal(i_b, idx) and torch.equal(d_b, d2),
              f"{name} differs from kernel B")
        check(torch.equal(i9, i9_p) and torch.equal(d9, d9_p),
              f"{name} differs from its plain version")
        visit_margin = knn_visit_margin(pts, verts, v9, v9_p)
        check(visit_margin <= KNN_VISIT_MARGIN,
              f"{name}: visit counts differ from knn_cull_lists off the "
              f"threshold ({visit_margin:.3g})")
        n_chunks = -(-verts.shape[0] // knn.VERT_CHUNK)
        share = v9.float().mean().item() / n_chunks
        t_c1 = cuda_ms(lambda: fn(q, verts), 20)
        t_b1 = cuda_ms(lambda: brute(q, verts), 20)
        t_b2 = cuda_ms(lambda: brute(q, verts), 20)
        t_c2 = cuda_ms(lambda: fn(q, verts), 20)
        # the same points and vertices, both in Morton order (tiles and
        # chunks then have compact boxes): here chunks are really skipped
        p_s = pts[order_p].contiguous()
        q_s = p_s if q is pts else p_s.t().contiguous()
        i_s, d_s, v_s = fn(q_s, verts_s, visits=True)
        i_sp, d_sp, v_sp = fn_p(q_s, verts_s, visits=True)
        i_sb, d_sb = brute(q_s, verts_s)
        torch.cuda.synchronize()
        check(torch.equal(i_s, i_sb) and torch.equal(d_s, d_sb)
              and torch.equal(i_s, i_sp) and torch.equal(d_s, d_sp),
              f"{name}, Morton order: differs from kernel B or its plain "
              "version")
        d_back = torch.empty_like(d_s)
        d_back[order_p] = d_s
        i_back = torch.empty_like(i_s)
        i_back[order_p] = order_v[i_s.long()].to(i_s.dtype)
        check(torch.equal(d_back, d2), f"{name}, Morton order: d2 differs "
              "from kernel B's on the mesh-ordered vertices")
        moved = i_back != idx      # only between vertices at one distance
        check(torch.equal(((pts[moved] - verts[i_back[moved].long()]) ** 2)
                          .sum(-1), d2[moved]),
              f"{name}, Morton order: another vertex off a tie")
        margin_s = knn_visit_margin(p_s, verts_s, v_s, v_sp)
        check(margin_s <= KNN_VISIT_MARGIN,
              f"{name}, Morton order: visit counts differ from "
              f"knn_cull_lists off the threshold ({margin_s:.3g})")
        share_s = v_s.float().mean().item() / n_chunks
        check(share_s < 1.0, f"{name}, Morton order: no chunk was skipped")
        t_s = [cuda_ms(lambda f=f: f(q_s, verts_s), 20)
               for f in (fn, brute, brute, fn)]
        coherent = dict(visit_share=share_s, ms=0.5 * (t_s[0] + t_s[3]),
                        brute_ms=0.5 * (t_s[1] + t_s[2]),
                        tiles_skipping=int((v_s < n_chunks).sum()),
                        visits_differ_from_plain=int((v_s != v_sp).sum()))
        # the visited pairs: a tile's 256 points against its chunks' vertices
        sizes = torch.full((n_chunks,), float(knn.VERT_CHUNK), device=dev)
        sizes[-1] = verts.shape[0] - knn.VERT_CHUNK * (n_chunks - 1)
        need, _ = knn.knn_cull_lists(
            *[f(knn._edge_tiles(pts, knn.CULL_TILE_P), 1)
              for f in (torch.amin, torch.amax)], verts)
        visited = (need.float() @ sizes).sum().item() * knn.CULL_TILE_P
        # the chunk-box kernel the entry point launches in front of the
        # search, alone: its rows, and its time beside the search's
        boxes = knn.vertex_chunk_boxes_cuda(verts)
        check(torch.equal(boxes, knn.vertex_chunk_boxes(verts)),
              f"{name}: the chunk boxes differ from vertex_chunk_boxes")
        results[name] = dict(
            shape=f"{pts.shape[0]} points x {verts.shape[0]} vertices, "
                  f"{share:.3f} of the (tile, chunk) pairs visited",
            max_abs_err=(d9 - d9_p).abs().max().item(),
            equals_kernel_b=True, visit_share=share, coherent=coherent,
            visits_differ_from_plain=int((v9 != v9_p).sum()),
            ms=0.5 * (t_c1 + t_c2), brute_ms=0.5 * (t_b1 + t_b2),
            device_ms=graph_ms(lambda: fn(q, verts)),
            boxes_ms=cuda_ms(lambda: knn.vertex_chunk_boxes_cuda(verts), 20),
            boxes_device_ms=graph_ms(
                lambda: knn.vertex_chunk_boxes_cuda(verts)),
            issue_bound_ms=issue_bound_ms(KNN_OPS * visited),
            ptxas=ptxas_summary(ptxas_report(_cuda.build_log,
                                             "knn_culled_kernel")),
            plain_ms=cuda_ms(lambda: fn_p(q, verts), 3),
            library_ms=cuda_ms(lambda: torch.cdist(pts, verts).min(1), 3),
            all_pairs=least_time(nbytes(pts, verts, i9, d9),
                                 KNN_OPS * n_pairs_knn),
            **least_time(nbytes(pts, verts, i9, d9), KNN_OPS * visited))

    # --- 9 on MANO-ordered hands: the two synthetic MANO hands posed by
    # mano_forward_np and sealed (2 x 779 vertices in MANO's own order,
    # ring after ring along each hand), at the fixture's hand positions ---
    results["knn_culled"]["mano"] = knn_culled_mano(pts, dev)

    # --- A and 7: the culled mesh query, in 1-D tiles (16 rays x 8
    # samples) and in VANERF_BLOCK_2D=4,4,8 tiles, without and with the far
    # tier, against its plain version, against the sweep over every face
    # of the same sorted table, and against the sweep over the table in
    # mesh order ---
    far2 = 0.02 ** 2
    p_c = (pts - mesh["center"]).contiguous()
    p_c_T = p_c.t().contiguous()
    with env(VANERF_BLOCK_2D="4,4,8"):
        tilings = {"1d": mesh_query.tile_geometry(p_c.shape[0], S_C),
                   "2d": mesh_query.tile_geometry(p_c.shape[0], S_C,
                                                  rays_hw=(PATCH, PATCH))}
    check(tilings["1d"] == (1, PATCH * PATCH, S_C, 1, 16, 8)
          and tilings["2d"] == (PATCH, PATCH, S_C, 4, 4, 8),
          f"tile geometry {tilings}")
    tilings["consecutive"] = None
    for name, fn, fn_p, q in (
            ("mesh_query", mesh_query.point_mesh_query_vis_culled,
             mesh_query.point_mesh_query_vis_culled_plain, p_c),
            ("mesh_query_T", mesh_query.point_mesh_query_vis_culled_T,
             mesh_query.point_mesh_query_vis_culled_T_plain, p_c_T)):
        results[name] = culled_query_checks(name, fn, fn_p, q, p_c, mesh, d2,
                                            tilings, far2)
    for k in ("d2", "idx", "wind", "qvis"):
        check(torch.equal(results["mesh_query_T"]["out"][k],
                          results["mesh_query"]["out"][k]),
              f"kernel 7 {k} differs from kernel A on the transposed input")
    for name in ("mesh_query", "mesh_query_T"):
        results[name].pop("out")
        results[name].pop("far", None)
    results["mesh_query_T"]["equals_kernel_a"] = True
    results["mesh_query"]["sizes_ms"] = culled_size_checks(
        p_c, batch, vert_vis, d2, far2)

    # --- 8: nearest vertex on coordinate-major points ---
    idx8, d28 = knn.nearest_vertex_d2_T(pts_T, verts)
    idx8_p, d28_p = knn.nearest_vertex_d2_T_plain(pts_T, verts)
    torch.cuda.synchronize()
    check(torch.equal(idx8, idx) and torch.equal(d28, d2),
          "kernel 8 differs from kernel B on the transposed input")
    check(torch.equal(d28, d28_p), "knn_T d2 differs from its plain version")
    results["knn_T"] = dict(
        shape=f"3 x {pts_T.shape[1]} points x {verts.shape[0]} vertices",
        max_abs_err=(d28 - d28_p).abs().max().item(),
        index_mismatch=int((idx8 != idx8_p).sum()), equals_kernel_b=True,
        ms=cuda_ms(lambda: knn.nearest_vertex_d2_T(pts_T, verts), 20),
        device_ms=graph_ms(lambda: knn.nearest_vertex_d2_T(pts_T, verts)),
        issue_bound_ms=issue_bound_ms(
            KNN_OPS * pts.shape[0] * verts.shape[0]),
        plain_ms=cuda_ms(lambda: knn.nearest_vertex_d2_T_plain(pts_T, verts),
                         3),
        library_ms=cuda_ms(lambda: torch.cdist(pts_T.t(), verts).min(1), 3),
        **least_time(nbytes(pts_T, verts, idx8, d28),
                     KNN_OPS * pts.shape[0] * verts.shape[0]))

    # --- 5, 6: the exact queries over every face, both winding modes, on
    # the uncentred points and mesh the public API hands them ---
    tri_w = verts[batch["faces"].long()].contiguous()
    face_vis = vert_vis[..., 0][batch["faces"].long()].contiguous()
    # the unfolded crossing test against kernel A's folded one, on A's own
    # (centred) points and corners
    wind_a = mesh_query.point_mesh_query_vis_cuda(p_c, mesh["table"], d2)[2]
    wind_5 = mesh_query.point_mesh_query_brute(
        p_c, mesh["table"][:, :9].reshape(-1, 3, 3), mode="ray")[2]
    differ = wind_5 != wind_a
    crossings_differ = int(differ.sum())
    # v and t round differently with the unfolded constants, so a count may
    # differ only where the ray grazes an edge of a face to within rounding
    graze = (ray_edge_margin(p_c[differ], mesh["table"]).max().item()
             if crossings_differ else 0.0)
    check(crossings_differ <= GRAZE_SHARE * pts.shape[0]
          and graze <= GRAZE_MARGIN,
          f"{crossings_differ} crossing counts of kernel 5 differ from "
          f"kernel A's, the farthest {graze:.3g} (barycentric units) from "
          "an edge")
    n_pairs = pts.shape[0] * tri_w.shape[0]
    # what the kernels evaluate past the per-face sphere test: the same for
    # 5 and 6 and for both winding modes
    work_b = mesh_query.brute_work(pts, mesh_query.brute_face_table(tri_w))
    ptx_b = ptxas_summary(ptxas_report(_cuda.build_log,
                                       "mesh_query_brute_kernel"))
    for name, vis in (("mesh_query_brute", False),
                      ("mesh_query_vis_brute", True)):
        r = dict(shape=f"{pts.shape[0]} points x {tri_w.shape[0]} faces, "
                       "ray + solid-angle winding",
                 max_abs_err=0.0, ms=0.0, device_ms=0.0,
                 work_issue_bound_ms=0.0, plain_ms=0.0, library_ms=None,
                 brute_work=work_b, ptxas=ptx_b, detail={})
        b_bytes = b_ops = 0
        table_b = mesh_query.brute_face_table(tri_w,
                                              face_vis if vis else None)
        for mode, w_ops in (("ray", MESH_CROSS_UNFOLDED_OPS),
                            ("solid_angle", MESH_SOLID_ANGLE_OPS)):
            if vis:
                run = lambda: mesh_query.point_mesh_query_vis_brute(
                    pts, tri_w, face_vis, mode=mode)
                run_p = lambda: mesh_query.point_mesh_query_vis_brute_plain(
                    pts, tri_w, face_vis, mode=mode)
            else:
                run = lambda: mesh_query.point_mesh_query_brute(
                    pts, tri_w, mode=mode)
                run_p = lambda: mesh_query.point_mesh_query_brute_plain(
                    pts, tri_w, mode=mode)
            got, want = run(), run_p()
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"{name} {mode}: d2 differs")
            check(torch.equal(got[1], want[1]), f"{name} {mode}: idx differs")
            e_w = (got[2] - want[2]).abs().max().item()
            check(e_w <= (SOLID_WIND_ATOL if mode == "solid_angle" else 0.0),
                  f"{name} {mode}: winding err {e_w}")
            d = dict(max_abs_err_wind=e_w)
            if vis:
                check(torch.equal(got[3], want[3]),
                      f"{name} {mode}: qvis differs")
            if mode == "ray":
                d["crossings_differ_from_a"] = crossings_differ
                d["their_edge_margin"] = graze
            d["ms"] = cuda_ms(run, 5)
            # the kernel alone on its table (the entry point also builds
            # the table, a dozen small tensor ops)
            d["device_ms"] = graph_ms(
                lambda: mesh_query._brute_cuda(pts, table_b, vis, mode), 5)
            d["plain_ms"] = cuda_ms(run_p, 2)
            # a sphere test a pair, the distance where a warp keeps the
            # face, the winding term a pair, at the issue rate
            d["work_issue_bound_ms"] = issue_bound_ms(
                work_b["sphere_tests"] * MESH_SPHERE_OPS
                + work_b["evaluated"] * MESH_DIST_OPS
                + work_b["windings"] * w_ops)
            d.update(least_time(
                nbytes(pts, table_b, *[t for t in got if t is not None]),
                n_pairs * (MESH_DIST_OPS + w_ops)))
            r["detail"][mode] = d
            r["max_abs_err"] = max(r["max_abs_err"], e_w)
            for k in ("ms", "device_ms", "work_issue_bound_ms", "plain_ms"):
                r[k] += d[k]
            b_bytes += d["bound_bytes"]
            b_ops += d["bound_ops"]
        # with no winding (kernel 5 only): bit-equal, not timed
        if not vis:
            got = mesh_query.point_mesh_query_brute(pts, tri_w,
                                                    with_winding=False)
            want = mesh_query.point_mesh_query_brute_plain(
                pts, tri_w, with_winding=False)
            torch.cuda.synchronize()
            check(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
                  f"{name} without winding differs")
        r.update(least_time(b_bytes, b_ops))
        results[name] = r

    # --- C: 256^2 raster of the mesh in the source view, then the port's
    # other rasters and the edge cases, each equal to the sweep over every
    # face (raster_plain) bit for bit ---
    krt = batch["src_krt"][0]
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    xy_pix = vh[:, :2] / (vh[:, 2:3] + 1e-8)
    tri = rasterize._packed_faces(xy_pix, vh[:, 2], batch["faces"])
    batch_np = {k: batch[k].cpu().numpy() for k in (
        "verts", "faces", "src_krt", "znear", "zfar", "tar_k", "tar_rt")}
    c_cases = [("the source view, 256^2", tri, H, W)] + [
        (t, torch.from_numpy(x).to(dev), h_, w_)
        for t, x, h_, w_ in raster_cases(batch_np)]
    c_detail = {}
    for tag, tri_c, h_, w_ in c_cases:
        face, zbuf = rasterize.raster_cuda(tri_c, h_, w_)
        face_p, zbuf_p = rasterize.raster_plain(tri_c, h_, w_)
        torch.cuda.synchronize()
        check(torch.equal(face, face_p) and torch.equal(zbuf, zbuf_p),
              f"raster ({tag}): differs from the sweep over every face in "
              f"{int((face != face_p).sum())} face ids, "
              f"{int((zbuf != zbuf_p).sum())} depths")
        work = rasterize.raster_work(tri_c.cpu(), h_, w_)
        c_detail[tag] = dict(
            shape=f"{h_}x{w_} pixels x {tri_c.shape[0]} faces",
            hit_share=(face >= 0).float().mean().item(),
            kept_share=work["kept"] / work["tests"],
            pair_share=work["pairs"] / (h_ * w_ * tri_c.shape[0]))
    face, zbuf = rasterize.raster_cuda(tri, H, W)
    check((face >= 0).float().mean().item() > 0.01, "raster hit nothing")
    work = rasterize.raster_work(tri.cpu(), H, W)

    def empty():        # on the current stream (a graph captures its own)
        _cuda.check(_cuda.lib().vt_empty(_cuda.stream_ptr(dev)), "vt_empty")

    results["rasterize"] = dict(
        shape=f"{H}x{W} pixels x {tri.shape[0]} faces",
        max_abs_err=0.0, face_mismatch=0, cases=c_detail, raster_work=work,
        ms=cuda_ms(lambda: rasterize.raster_cuda(tri, H, W), 20),
        device_ms=graph_ms(lambda: rasterize.raster_cuda(tri, H, W)),
        empty_ms=cuda_ms(empty, 20), empty_device_ms=graph_ms(empty),
        plain_ms=cuda_ms(lambda: rasterize.raster_plain(tri, H, W), 3),
        library_ms=None,
        work_issue_bound_ms=issue_bound_ms(
            work["tests"] * RASTER_TEST_OPS
            + work["certified"] * 2 * RASTER_CERT_F64_OPS
            + work["pairs"] * RASTER_PAIR_ISSUE),
        all_pairs=least_time(nbytes(tri, face, zbuf),
                             RASTER_OPS * H * W * tri.shape[0]),
        ptxas=ptxas_report(_cuda.build_log, "raster_kernel"),
        **least_time(nbytes(tri, face, zbuf), RASTER_OPS * work["pairs"]))

    # --- D: the 32^2 x 64 geo-coarse map, then a 64^2 x 16 map at the
    # patch's points, then the edge cases; every case bit-equal to the
    # plain version and across two runs ---
    results["interp_mxu"] = kernel_cases(interp_cases(geo_coarse, uv, dev),
                                         interp_case)

    # --- 14: feat_sample_nhwc's three maps at the patch's points, the
    # serving launches, then the edge cases; every case bit-equal to the
    # plain version and across two runs ---
    results["bilinear"] = kernel_cases(
        bilinear_cases(model, batch, uv, dev), bilinear_case)

    # --- 13: the take_rows table gradient at the training path's four
    # shapes, then the edge cases ---
    v_uv = torch.stack([2.0 * xy_pix[:, 0] / (W - 1.0) - 1.0,
                        2.0 * xy_pix[:, 1] / (H - 1.0) - 1.0], -1)
    results["onehot_scatter"] = kernel_cases(
        scatter_cases(idx, verts.shape[0], geo_coarse, uv, v_uv, dev),
        scatter_case)

    # --- 10, 11, 12: the row gather and the fused query kernels on what the
    # model's own branches hand them for the same patch ---
    fin = fused_main_path_inputs(model, batch, grids)
    (table, ridx), _ = fin["mxu_row_gather"]
    # the query hands kernel 10 the frame's table and the batch's rows
    table, ridx = table[0].contiguous(), ridx[0].to(torch.int32).contiguous()
    check(table.shape == (verts.shape[0], 204) and ridx.shape[0]
          == pts.shape[0], f"row gather shapes {table.shape} {ridx.shape}")
    got = interp_mxu.row_gather_cuda(table, ridx)
    want = interp_mxu.row_gather_plain(table, ridx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "row gather differs from table[idx]")
    results["row_gather"] = dict(
        shape=f"{ridx.shape[0]} rows of a {table.shape[0]}x{table.shape[1]} "
              "table",
        max_abs_err=(got - want).abs().max().item(),
        ms=cuda_ms(lambda: interp_mxu.row_gather_cuda(table, ridx), 20),
        plain_ms=cuda_ms(lambda: interp_mxu.row_gather_plain(table, ridx),
                         20),
        library_ms=cuda_ms(lambda: table.index_select(0, ridx), 20),
        **least_time(nbytes(table, ridx, got), 0))

    def mlp_macs(mats):
        return sum(m.shape[0] * m.shape[1] for m in mats)

    n_pts, n_kpt = pts.shape[0], batch["kpt3d"].shape[1]
    pe_ops = 35 * n_kpt        # per point: differences, exp, sincos, octaves
    for name, cuda_fn, plain_fn, packs in (
            ("fused_geo_mlp", fused_mlp.fused_geo_mlp_cuda,
             fused_mlp.fused_geo_mlp_plain, 1),
            ("fused_query_mlp", fused_mlp.fused_query_mlp_cuda,
             fused_mlp.fused_query_mlp_plain, 2)):
        a, k = fin[name]
        data = [t.contiguous() for t in a[:2 + packs]]
        wts = a[2 + packs]
        # the buffers the model packed once for the frame: the kernel's time
        # below is the launch alone, as every pass after the first pays it
        k = dict(k)
        packed = k.pop("packed")
        check(packed is not None, f"{name}: the model packed no weights")
        check(data[0].shape == (n_pts, 3), f"{name}: {data[0].shape} points")
        as_tuple = (lambda x: x if isinstance(x, tuple) else (x,))
        got = as_tuple(cuda_fn(*data, packed, **k))
        want = as_tuple(plain_fn(*data, wts, **k))
        torch.cuda.synchronize()
        worst = max(of_bound(g_, w_, FUSED_RTOL, FUSED_ATOL)
                    for g_, w_ in zip(got, want))
        check(worst <= 1.0, f"{name}: {worst:.3g} x the bound rtol "
              f"{FUSED_RTOL} atol {FUSED_ATOL}")
        flat = [w for g_ in wts.values()
                for w in (g_ if isinstance(g_, (list, tuple)) else [g_])]
        mats = [w for w in flat if w.shape[0] > 1]
        macs = mlp_macs(mats)
        # the CUDA cores' share: the encoding, and a bias and an activation
        # (softplus ~8 operations) on every output channel of every layer
        core_ops = n_pts * (pe_ops + 8 * sum(m.shape[1] for m in mats))
        entry = "fused_query_kernel" if packs == 2 else "fused_geo_kernel"
        ptx = fused_ptxas(_cuda.build_log, entry, bf16=False)
        results[name] = dict(
            device_ms=graph_ms(lambda: cuda_fn(*data, packed, **k)),
            tensor_bound_ms=(3 * 2 * macs * n_pts / TF32_FLOPS_PER_S
                             + core_ops / F32_FLOPS_PER_S) * 1e3,
            ptxas=ptxas_summary(ptx),
            shape=f"{n_pts} points, {n_kpt} keypoints, packs "
                  + " ".join(str(t.shape[1]) for t in data[2:])
                  + f", {macs} multiply-adds a point",
            max_abs_err=max((g_ - w_).abs().max().item()
                            for g_, w_ in zip(got, want)),
            of_bound=worst, macs_per_point=macs,
            ms=cuda_ms(lambda: cuda_fn(*data, packed, **k), 5),
            plain_ms=cuda_ms(lambda: plain_fn(*data, wts, **k), 5),
            library_ms=None,
            **least_time(nbytes(*data, *flat, *got),
                         n_pts * (2 * macs + pe_ops)))
    return results


# ---------------------------------------------------------------------------
# phase 2b: the bfloat16 forms of kernels D, 10, 11 and 12
# ---------------------------------------------------------------------------

def bf16_model(model, cfg, num_v: int):
    """The same weights as ``model`` in the bfloat16 serving configuration,
    made as a user makes it: ``VANeRF.from_config`` under
    ``VANERF_COMPUTE_DTYPE=bfloat16``."""
    from vanerf_tpu_torch.models import VANeRF
    with env(VANERF_COMPUTE_DTYPE="bfloat16"):
        m16 = VANeRF.from_config(cfg, num_v=num_v, image_hw=(H, W))
    check(m16.compute_dtype == "bfloat16", "VANERF_COMPUTE_DTYPE not read")
    m16.load_state_dict(model.state_dict())
    return m16.to(next(model.parameters()).device).eval()


class ktiles_reversed:
    """For the length of a ``with`` block every matrix product ``x @ w``
    sums its 16-row k-tiles in reverse order (each tile one product): the
    second summation order that kernels 11 / 12's bfloat16 bound is taken
    from."""

    def __init__(self):
        import torch

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                    x, w = args
                    acc = None
                    for k0 in reversed(range(0, w.shape[0], 16)):
                        d = x[..., k0:k0 + 16] @ w[k0:k0 + 16]
                        acc = d if acc is None else acc + d
                    return acc
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


class unrounded:
    """For the length of a ``with`` block the fused kernels' plain
    versions keep float32 between their layers (their rounding to
    bfloat16 the identity): the control that kernels 11 / 12's bfloat16
    bound must reject."""

    def __enter__(self):
        from vanerf_tpu_torch.ops import fused_mlp
        self.real = fused_mlp._rounder
        fused_mlp._rounder = lambda cdt: (lambda x: x)

    def __exit__(self, *exc):
        from vanerf_tpu_torch.ops import fused_mlp
        fused_mlp._rounder = self.real


def interp_cases_bf16(geo_coarse, uv, dev):
    """Kernel D's bfloat16 cases: the main path's 32^2 x 64 geometry
    coarse map in bfloat16 at the patch's points (the kernels line), then
    the scalar-lane instantiation (6 channels, a table or a uv off a 16- /
    8-byte boundary) and a slice of a batch."""
    import torch
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    coarse = geo_coarse.to(bf).contiguous()
    batch = torch.randn(2, 32, 32, 64, generator=g, device=dev).to(bf)
    wide = (uv * 1.3).contiguous()
    return [("32^2x64 bfloat16", True, coarse, uv),
            ("16^2x6 bfloat16, scalar lanes", False,
             torch.randn(16, 16, 6, generator=g, device=dev).to(bf),
             wide[:5001]),
            ("32^2x64 bfloat16 slice feat[1] of a batch, uv beyond [-1, 1]",
             False, batch[1], wide[:5001]),
            ("32^2x64 bfloat16 table off 16 bytes", False,
             offset_view(coarse, 1), uv[:4999].contiguous()),
            ("32^2x64 bfloat16, uv off 8 bytes", False, coarse,
             offset_view(wide[:777], 1))]


def bf16_other_width_model(model16, cfg):
    """``model16`` at the geometry MLP widths BF16_OTHER_WIDTHS (bfloat16,
    its weights where the shapes agree, the reshaped layers seeded), as a
    user builds it: ``VANeRF.from_config`` under
    ``VANERF_COMPUTE_DTYPE=bfloat16``."""
    with env(VANERF_COMPUTE_DTYPE="bfloat16"):
        m = variant_model(model16, variant_cfg(cfg, **{
            f"mlp_geo_args.{k}": v for k, v in BF16_OTHER_WIDTHS.items()}),
            SEED + 7)
    check(m.compute_dtype == "bfloat16", "VANERF_COMPUTE_DTYPE not read")
    return m


def variant_model(model, cfg, seed: int):
    """The model of ``cfg`` on ``model``'s device in eval mode: ``model``'s
    weights under every key whose shape agrees (the encoders and whatever
    the variant leaves alone), the rest initialised from ``seed`` as
    ``init_like_flax`` does."""
    import torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    m = VANeRF.from_config(cfg, num_v=model.num_v, image_hw=(H, W))
    init_like_flax(m, torch.Generator().manual_seed(seed))
    sd, own = model.state_dict(), m.state_dict()
    m.load_state_dict({k: (sd[k] if k in sd and sd[k].shape == v.shape
                           else v) for k, v in own.items()})
    return m.to(next(model.parameters()).device).eval()


def phase_kernels_bf16(model16, batch, cfg, dev):
    """Kernels D, 10, 11 and 12 in bfloat16 at the shapes the bfloat16
    main path gives them, each against its plain version: D and 10 bit for
    bit; 11 and 12 within FUSED_BF16_SPREAD_X times the spread between two
    summation orders of the plain version, on every output, in the wgmma
    body at the shipped widths and in the mma.sync body at another."""
    import torch
    from vanerf_tpu_torch.ops import fused_mlp, interp_mxu, knn
    bf = torch.bfloat16
    results = {}
    pts, _mesh, geo_coarse, uv, grids, _vv = main_path_points(model16, batch)
    results["interp_mxu_bf16"] = kernel_cases(
        interp_cases_bf16(geo_coarse, uv, dev), interp_case)

    # --- 13 in bfloat16: phase 2's four training-path shapes, then scalar
    # lanes (5 channels) ---
    verts = batch["verts"][0].contiguous()
    idx, _ = knn.nearest_vertex_d2(pts, verts)
    krt = batch["src_krt"][0]
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    xy_pix = vh[:, :2] / (vh[:, 2:3] + 1e-8)
    v_uv = torch.stack([2.0 * xy_pix[:, 0] / (W - 1.0) - 1.0,
                        2.0 * xy_pix[:, 1] / (H - 1.0) - 1.0], -1)
    cases = [c for c in scatter_cases(idx, verts.shape[0], geo_coarse, uv,
                                      v_uv, dev)
             if c[1] or c[0] == "scalar channels"]
    results["onehot_scatter_bf16"] = kernel_cases(cases, scatter_case_bf16)

    fin = fused_main_path_inputs(model16, batch, grids)
    (table, ridx), _ = fin["mxu_row_gather"]
    table, ridx = table[0].contiguous(), ridx[0].to(torch.int32).contiguous()
    check(table.dtype == bf and table.shape == (batch["verts"].shape[1], 204)
          and ridx.shape[0] == pts.shape[0],
          f"bfloat16 row gather: {table.dtype} {table.shape} {ridx.shape}")
    got = interp_mxu.row_gather_cuda(table, ridx)
    want = interp_mxu.row_gather_plain(table, ridx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "bfloat16 row gather differs from "
          "table[idx]")
    results["row_gather_bf16"] = dict(
        shape=f"{ridx.shape[0]} rows of a {table.shape[0]}x{table.shape[1]} "
              "bfloat16 table",
        max_abs_err=(got.float() - want.float()).abs().max().item(),
        ms=cuda_ms(lambda: interp_mxu.row_gather_cuda(table, ridx), 20),
        device_ms=graph_ms(lambda: interp_mxu.row_gather_cuda(table, ridx)),
        plain_ms=cuda_ms(lambda: interp_mxu.row_gather_plain(table, ridx),
                         20),
        library_ms=cuda_ms(lambda: table.index_select(0, ridx), 20),
        library_device_ms=graph_ms(lambda: table.index_select(0, ridx)),
        **least_time(nbytes(table, ridx, got), 0))

    # --- 11 / 12's softplus and sigmoid on every bfloat16 input ---
    acts = {}
    for act_name, act in (("softplus", fused_mlp.ACT_SOFTPLUS),
                          ("sigmoid", fused_mlp.ACT_SIGMOID)):
        got = fused_mlp.act_bf16_all_cuda(act, dev)
        want = fused_mlp.act_bf16_all_plain(act, dev)
        torch.cuda.synchronize()
        nan = torch.isnan(got.float()) & torch.isnan(want.float())
        differ = int((~((got.view(torch.int16) == want.view(torch.int16))
                        | nan)).sum())
        check(differ == 0, f"bfloat16 {act_name}: {differ} of the 65,536 "
              "inputs differ from the plain version")
        acts[act_name] = dict(inputs=got.numel(), differ=differ,
                              nan=int(nan.sum()))
    results["fused_act_bf16"] = acts

    results.update(fused_bf16_checks(fin, pts.shape[0],
                                     batch["kpt3d"].shape[1]))
    # the mma.sync body (csrc/fused_mlp.cu, BF = true), which the
    # bfloat16 weights of every other width are packed for, at one such
    # width (BF16_OTHER_WIDTHS) on the same patch
    model_w = bf16_other_width_model(model16, cfg)
    results.update(fused_bf16_checks(
        fused_main_path_inputs(model_w, batch, grids), pts.shape[0],
        batch["kpt3d"].shape[1], body=fused_mlp.BODY_BF16_MMA))
    return results


def fused_bf16_checks(fin, n_pts: int, n_kpt: int, body: str = "_bf16"):
    """Kernels 12 and 11 in bfloat16 on the arguments the model's fused
    branches handed them (``fin``, :func:`fused_main_path_inputs`), their
    weights packed for ``body`` (the wgmma body, or the mma.sync body
    at another width), each against its plain version: the RMS error
    within FUSED_BF16_SPREAD_X times the RMS spread between two summation
    orders of the plain version, a bound the plain version without its
    roundings must fail, and every element within twice the plain
    version's bfloat16-vs-float32 spread; times, bound and ptxas."""
    import ctypes

    import torch
    from vanerf_tpu_torch.ops import _cuda, fused_mlp
    bf = torch.bfloat16
    results = {}
    pe_ops = 35 * n_kpt
    as_tuple = (lambda x: x if isinstance(x, tuple) else (x,))
    for kern, cuda_fn, plain_fn, packs in (
            ("fused_geo_mlp", fused_mlp.fused_geo_mlp_cuda,
             fused_mlp.fused_geo_mlp_plain, 1),
            ("fused_query_mlp", fused_mlp.fused_query_mlp_cuda,
             fused_mlp.fused_query_mlp_plain, 2)):
        name = kern + body
        a, k = fin[kern]
        data = [t.contiguous() for t in a[:2 + packs]]
        wts = a[2 + packs]
        k = dict(k)
        packed = k.pop("packed")
        check(packed is not None and packed.w.dtype == bf
              and packed.body == body
              and all(t.dtype == bf for t in data[2:]),
              f"{name}: the model's bfloat16 branch handed "
              f"{[t.dtype for t in data[2:]]}, packs "
              f"{packed and (packed.w.dtype, packed.body)}")
        got = as_tuple(cuda_fn(*data, packed, **k))
        want = as_tuple(plain_fn(*data, wts, **k))
        with ktiles_reversed():
            other = as_tuple(plain_fn(*data, wts, **k))
        with unrounded():
            control = as_tuple(plain_fn(*data, wts, **k))
        torch.cuda.synchronize()
        def diffs(outs, norm):
            return [norm(g_.float() - w_.float()) for g_, w_ in zip(outs, want)]

        def of(err, spread):
            return max(e / s if s > 0 else (0.0 if e == 0 else float("inf"))
                       for e, s in zip(err, spread))

        def amax(x):
            return x.abs().max().item()

        def rms(x):
            return x.double().pow(2).mean().sqrt().item()

        spread, spread_rms = diffs(other, amax), diffs(other, rms)
        err, s16 = diffs(got, amax), diffs(control, amax)
        of_spread, of_spread_rms = of(err, spread), of(diffs(got, rms),
                                                        spread_rms)
        control_of_spread = of(s16, spread)
        control_of_spread_rms = of(diffs(control, rms), spread_rms)
        of_s16 = of(err, s16)
        check(of_spread_rms <= FUSED_BF16_SPREAD_X,
              f"{name}: RMS error against the plain version "
              f"{of_spread_rms:.3g} x the RMS spread of two summation "
              f"orders (bound {FUSED_BF16_SPREAD_X} x)")
        check(control_of_spread_rms > FUSED_BF16_SPREAD_X,
              f"{name}: the plain version without its bfloat16 roundings "
              f"lies within the RMS bound ({control_of_spread_rms:.3g} x)")
        check(of_s16 <= 2.0, f"{name}: errors {err} against the plain "
              f"version, {of_s16:.3g} x its bfloat16-vs-float32 spread "
              f"{s16} (bound 2 x)")
        flat = [w for g_ in wts.values()
                for w in (g_ if isinstance(g_, (list, tuple)) else [g_])]
        mats = [w for w in flat if w.shape[0] > 1]
        macs = sum(m.shape[0] * m.shape[1] for m in mats)
        core_ops = n_pts * (pe_ops + 8 * sum(m.shape[1] for m in mats))
        tensor_ms = (2 * macs * n_pts / BF16_FLOPS_PER_S
                     + core_ops / F32_FLOPS_PER_S) * 1e3
        lt = least_time(nbytes(*data, *flat, *got),
                        n_pts * (2 * macs + pe_ops))
        bytes_ms = lt["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        mma = body == fused_mlp.BODY_BF16_MMA
        if mma:
            entry = "fused_query_kernel" if packs == 2 else "fused_geo_kernel"
            occ = dict(smem_bytes=None, blocks_per_sm=None, threads=None)
        else:
            entry = "fw_query_kernel" if packs == 2 else "fw_geo_kernel"
            o = (ctypes.c_int * 3)()
            _cuda.check(_cuda.lib().vt_fused_mlp_bf16_occupancy(
                int(packs == 2), n_kpt, o), "vt_fused_mlp_bf16_occupancy")
            check(o[1] >= 1, f"{name}: no block fits an SM")
            occ = dict(smem_bytes=o[0], blocks_per_sm=o[1], threads=o[2])
        results[name] = dict(
            **occ,
            shape=f"{n_pts} points, {n_kpt} keypoints, bfloat16 packs "
                  + " ".join(str(t.shape[1]) for t in data[2:])
                  + f", {macs} multiply-adds a point, widths "
                  f"{list(packed.dims)}",
            max_abs_err=max(err), errors=err, spread=spread,
            of_spread=of_spread, of_spread_rms=of_spread_rms, of_s16=of_s16,
            control_of_spread=control_of_spread,
            control_of_spread_rms=control_of_spread_rms,
            macs_per_point=macs,
            ms=cuda_ms(lambda: cuda_fn(*data, packed, **k), 5),
            device_ms=graph_ms(lambda: cuda_fn(*data, packed, **k)),
            plain_ms=cuda_ms(lambda: plain_fn(*data, wts, **k), 5),
            library_ms=None, tensor_bound_ms=tensor_ms,
            ptxas=ptxas_summary(fused_ptxas(_cuda.build_log, entry,
                                            bf16=True, mma=mma)),
            bound_ms=max(bytes_ms, tensor_ms),
            bound_by="bytes" if bytes_ms >= tensor_ms else "operations",
            bound_bytes=lt["bound_bytes"], bound_ops=lt["bound_ops"])
    return results


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def phase_main_path(model, batches, dev):
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    ops.reset_launches()
    torch.cuda.synchronize()
    frame_ms, outs = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = tr.render_full_image(model, b, level=3, sample_per_ray_c=S_C,
                                   sample_per_ray_f=S_F)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    # bench-shaped group: 16 mask-centred 64x64 patches sharing one encode
    b = batches[0]
    gen = torch.Generator().manual_seed(SEED + 1)
    t0 = time.perf_counter()
    cached = tr.encode_frame(model, b)
    group = []
    for _ in range(16):
        grids = tr.mask_centered_grid(gen, b["tar_mask"][..., 0], PATCH,
                                      PATCH)
        group.append(tr.render_patch(
            model, b, grids=grids, out_h=PATCH, out_w=PATCH,
            sample_per_ray_c=S_C, sample_per_ray_f=S_F,
            compute_vis_map=False, cached=cached))
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    launches = ops.launch_counts()

    for out in outs + group:
        for k, v in out.items():
            if torch.is_tensor(v) and v.is_floating_point():
                check(torch.isfinite(v).all().item(), f"non-finite {k}")
    for out in outs:
        check(out["tex_fg_fine"].shape == (1, H, W, 3), "full-image shape")
        check(out["alpha_fine"].max().item() > 0.2,
              "full image: rays missed the hands")
    check(max(o["alpha_fine"].max().item() for o in group) > 0.2,
          "patch group: rays missed the hands")
    for name in ("mesh_query", "knn", "rasterize", "interp_mxu",
                 "row_gather", "bilinear"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    samples = PATCH * PATCH * (S_C + S_C + S_F) * 16
    return dict(frame_ms=frame_ms, group_s=group_s,
                ray_samples_per_s=samples / group_s, launches=launches,
                alpha_fine_max=[o["alpha_fine"].max().item() for o in outs])


# ---------------------------------------------------------------------------
# phase 3a: two encodes of one frame, equal to the bit
# ---------------------------------------------------------------------------

ENCODE_ROUNDS = 5


def phase_encode_repeat(model, b):
    """Two ``encode_frame`` calls of one frame must be equal to the bit:
    ``VANeRF.encode`` runs its convolutions under cuDNN's deterministic
    algorithms.  With that pin lifted (``VANeRF._encode``, the same encode
    under ``cudnn.flags(deterministic=False)``), forward hooks on every leaf
    module of the two encoders name the first one whose output differs
    between two calls; the pin's cost is the encode's time with and without
    it, in turns (host clock ending in a synchronise, median of
    ENCODE_ROUNDS)."""
    import statistics
    import torch
    from vanerf_tpu_torch import renderer as tr

    def flat(e):
        return [e[0][0], e[0][1], e[1], e[2]]

    first, second = flat(tr.encode_frame(model, b)), flat(
        tr.encode_frame(model, b))
    torch.cuda.synchronize()
    differ = [i for i, (x, y) in enumerate(zip(first, second))
              if not torch.equal(x, y)]
    check(not differ, f"two encode_frame calls differ in outputs {differ}")
    cd = torch.backends.cudnn

    def unpinned():
        with cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                      deterministic=False, allow_tf32=cd.allow_tf32):
            model._encode(b["src_img"])

    def hooked():
        seen = []
        hooks = [m.register_forward_hook(
            lambda _m, _i, o, n=name: seen.append((n, o)))
            for name, m in model.named_modules()
            if name.startswith(("geo_encoder", "tex_encoder"))
            and not list(m.children())]
        try:
            unpinned()
        finally:
            for hk in hooks:
                hk.remove()
        return seen

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    a, c = hooked(), hooked()
    torch.cuda.synchronize()
    first_diff = next(
        (n for (n, x), (_n, y) in zip(a, c) if torch.is_tensor(x)
         and not torch.equal(x, y)), None)
    pinned_ms, free_ms = [], []
    for _ in range(ENCODE_ROUNDS):
        free_ms.append(timed(unpinned))
        pinned_ms.append(timed(lambda: model.encode(b["src_img"])))
    return dict(equal=True, unpinned_first_differing_module=first_diff,
                leaf_modules=len(a), pinned_ms=pinned_ms, unpinned_ms=free_ms,
                pinned_median_ms=statistics.median(pinned_ms),
                unpinned_median_ms=statistics.median(free_ms))


# ---------------------------------------------------------------------------
# phase 3g: the frame with and without kernel D (VANERF_MXU_INTERP=0)
# ---------------------------------------------------------------------------

MXU_CONFIGS = {"D": dict(VANERF_MXU_INTERP="1"),
               "gather": dict(VANERF_MXU_INTERP="0")}
MXU_ROUNDS = 2
# the hat form (D) and the lerp form (grid_sample) of one bilinear sample
# round differently: the frames agree to phase 4's tolerance
MXU_RTOL, MXU_ATOL = 1e-3, 1e-4


def phase_mxu_interp_serving(model, b):
    """The frame with kernel D (the default) and under
    ``VANERF_MXU_INTERP=0`` (every map through the gather sampler), on one
    shared encode, held as phase 3b holds the fused frames at rtol 1e-3 /
    atol 1e-4, plus one patch with the fine depths pinned; 32 launches of D
    a frame, none under the switch; ms per frame of both in turns."""
    res = {name: dict(frame_ms=[]) for name in MXU_CONFIGS}
    outs = {}
    with shared_encode(model, b):
        for name, switches in MXU_CONFIGS.items():
            outs[name], _ms, counts = timed_frame(model, b, switches)
            res[name]["launches"] = counts["interp_mxu"]
    check(res["D"]["launches"] == 32 and res["gather"]["launches"] == 0,
          f"kernel D launches a frame: {res['D']['launches']} by default, "
          f"{res['gather']['launches']} under VANERF_MXU_INTERP=0")
    for _ in range(MXU_ROUNDS):
        for name, switches in MXU_CONFIGS.items():
            res[name]["frame_ms"].append(timed_frame(model, b, switches)[1])
    worst, share, abs_err = hold_to_fused_bounds(
        "VANERF_MXU_INTERP=0", [outs["gather"]], [outs["D"]], MXU_RTOL,
        MXU_ATOL)
    res["gather"].update(of_bound=worst, share_outside=share,
                         max_abs_err=abs_err)
    res["pinned"] = pinned_fine_depths(
        model, b, reference=MXU_CONFIGS["D"],
        configs={"gather": MXU_CONFIGS["gather"]}, rtol=MXU_RTOL,
        atol=MXU_ATOL)
    check(outs["D"]["alpha_fine"].max().item() > 0.2,
          "sampler phase: rays missed the hands")
    return res


# ---------------------------------------------------------------------------
# phase 3b: the fused-MLP serving configuration against the unfused render
# ---------------------------------------------------------------------------

FUSED_CONFIGS = {
    "unfused": dict(VANERF_FUSED_MLP="0"),
    "level2": dict(VANERF_FUSED_MLP="2"),
    "level1": dict(VANERF_FUSED_MLP="1"),
}
FUSED_KERNELS = {"unfused": ("row_gather",),
                 "level2": ("row_gather", "fused_query_mlp"),
                 "level1": ("row_gather", "fused_geo_mlp")}
FUSED_ROUNDS = 2
COARSE_KEYS = ("tex_fg", "alpha", "depth")


def pinned_fine_depths(model, b, reference=None, configs=None,
                       rtol=FUSED_RTOL, atol=FUSED_ATOL):
    """One mask-centred patch per configuration with the fine pass's
    depths pinned to the reference render's (the unfused one unless given):
    every floating output must lie within rtol / atol (2e-4 / 2e-5 unless
    given) of the reference, on every element."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    reference = FUSED_CONFIGS["unfused"] if reference is None else reference
    configs = ({k: FUSED_CONFIGS[k] for k in ("level2", "level1")}
               if configs is None else configs)
    grids = tr.mask_centered_grid(torch.Generator().manual_seed(SEED + 1),
                                  b["tar_mask"][..., 0], PATCH, PATCH)
    kw = dict(grids=grids, out_h=PATCH, out_w=PATCH, sample_per_ray_c=S_C,
              sample_per_ray_f=S_F, compute_vis_map=False)
    real, kept, worst = tr.importance_sample, [], {}
    try:
        tr.importance_sample = lambda *a, **k: (kept.append(real(*a, **k))
                                                or kept[-1])
        with env(**reference):
            want = tr.render_patch(model, b, **kw)
        tr.importance_sample = lambda *a, **k: kept[0]
        for name, switches in configs.items():
            with env(**switches):
                got = tr.render_patch(model, b, **kw)
            worst[name] = {
                k: of_bound(got[k], v, rtol, atol)
                for k, v in want.items()
                if torch.is_tensor(v) and v.is_floating_point()}
    finally:
        tr.importance_sample = real
    for name, w in worst.items():
        bad = {k: x for k, x in w.items() if not x <= 1.0}
        check(not bad, f"{name} with pinned fine depths, share of rtol "
              f"{rtol} atol {atol}: {bad}")
    check(want["alpha_fine"].max().item() > 0.2, "pinned patch missed")
    return worst


def hold_to_fused_bounds(name, outs_got, outs_want, rtol=FUSED_RTOL,
                         atol=FUSED_ATOL):
    """Frames (or patches) of a configuration against the reference's: the
    coarse pass within rtol / atol (2e-4 / 2e-5 unless given) on every
    element; the free-running fine outputs outside it on at most
    FUSED_FINE_SHARE of their elements, never by more than FUSED_FINE_ABS
    (see ``phase_fused_serving``).  Returns (of_bound, share_outside,
    max_abs_err) per output."""
    import torch
    acc_of = {"depth": "alpha", "depth_fine": "alpha_fine",
              "sdf": "alpha_fine"}
    worst, share, abs_err = {}, {}, {}
    for got, want in zip(outs_got, outs_want):
        for k, v in want.items():
            if not (torch.is_tensor(v) and v.is_floating_point()):
                continue
            check(torch.isfinite(got[k]).all().item(),
                  f"{name}: non-finite {k}")
            g_, w_ = got[k], v
            if k in acc_of:      # normalised by acc: hit rays only
                m = want[acc_of[k]] > 1e-2
                g_, w_ = g_[m], w_[m]
            err = (g_ - w_).abs()
            rel = err / (atol + rtol * w_.abs())
            worst[k] = max(worst.get(k, 0.0), rel.max().item())
            share[k] = max(share.get(k, 0.0),
                           (rel > 1.0).float().mean().item())
            abs_err[k] = max(abs_err.get(k, 0.0), err.max().item())
    for k in worst:
        if k in COARSE_KEYS or not k.endswith(("_fine", "sdf")):
            check(worst[k] <= 1.0, f"{name}: {k} at {worst[k]:.3g} x "
                  f"rtol {rtol} atol {atol}")
        else:
            check(share[k] <= FUSED_FINE_SHARE
                  and (k in acc_of or abs_err[k] <= FUSED_FINE_ABS),
                  f"{name}: {k} outside the bound on {share[k]:.2%} of "
                  f"its elements, max abs err {abs_err[k]:.3g}")
    return worst, share, abs_err


def phase_fused_serving(model, b, dev):
    """One frame and one 16-patch group per configuration and round, the
    configurations in turns; VANERF_FUSED_MLP is set in all three, so the
    far tier is off in all three."""
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    res = {name: dict(frame_ms=[], group_ms=[]) for name in FUSED_CONFIGS}
    outs = {}
    for rnd in range(FUSED_ROUNDS):
        for name, switches in FUSED_CONFIGS.items():
            with env(**switches):
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame = tr.render_full_image(model, b, level=3,
                                             sample_per_ray_c=S_C,
                                             sample_per_ray_f=S_F)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                gen = torch.Generator().manual_seed(SEED + 1)
                cached = tr.encode_frame(model, b)
                group = []
                for _ in range(16):
                    grids = tr.mask_centered_grid(gen, b["tar_mask"][..., 0],
                                                  PATCH, PATCH)
                    group.append(tr.render_patch(
                        model, b, grids=grids, out_h=PATCH, out_w=PATCH,
                        sample_per_ray_c=S_C, sample_per_ray_f=S_F,
                        compute_vis_map=False, cached=cached))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                counts = ops.launch_counts()
            res[name]["frame_ms"].append((t1 - t0) * 1e3)
            res[name]["group_ms"].append((t2 - t1) * 1e3)
            if rnd == 0:
                res[name]["launches"] = counts
                outs[name] = [frame] + group
                for kern in FUSED_KERNELS[name]:
                    check(counts[kern] > 0,
                          f"kernel {kern} was not launched under {switches}")
                for kern in ("row_gather", "fused_query_mlp",
                             "fused_geo_mlp"):
                    check(kern in FUSED_KERNELS[name] or counts[kern] == 0,
                          f"kernel {kern} ran under {switches}")
    # The coarse pass holds to the bound on every element.  The fine pass
    # samples depths by inverse CDF with the reference's guard
    # `den < 1e-5 -> 1` (ops/sampling.py), a step: a coarse weight that
    # differs in its last bits can move a fine sample of an empty bin
    # across it, which shifts that ray's fine colour by up to ~1e-2.  So
    # the free-running fine outputs may leave the bound on a small share of
    # pixels (FUSED_FINE_SHARE, never by more than FUSED_FINE_ABS), and
    # `pinned_fine_depths` below holds the fine pass to the bound on every
    # element with its depths pinned to the unfused render's.
    for name in ("level2", "level1"):
        worst, share, abs_err = hold_to_fused_bounds(name, outs[name],
                                                     outs["unfused"])
        res[name].update(of_bound=worst, share_outside=share,
                         max_abs_err=abs_err)
    res["pinned"] = pinned_fine_depths(model, b)
    check(outs["unfused"][0]["alpha_fine"].max().item() > 0.2,
          "fused phase: rays missed the hands")
    return res


# ---------------------------------------------------------------------------
# frames under environment switches (phases 3c, 3e, 3f)
# ---------------------------------------------------------------------------

def timed_frame(model, b, switches):
    """One ``render_full_image`` under ``switches``: (frame, ms, launches)."""
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    with env(**switches):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tr.render_full_image(model, b, level=3, sample_per_ray_c=S_C,
                                     sample_per_ray_f=S_F)
        torch.cuda.synchronize()
        return frame, (time.perf_counter() - t0) * 1e3, ops.launch_counts()


class shared_encode:
    """For the length of a ``with`` block every frame takes one encode of
    ``b``: two encodes of a frame differ in their last bits on the card
    (phase 3c), so frames that are compared share one."""

    def __init__(self, model, b):
        from vanerf_tpu_torch import renderer as tr
        self.tr, self.pinned = tr, tr.encode_frame(model, b)

    def __enter__(self):
        self.real = self.tr.encode_frame
        self.tr.encode_frame = lambda *a, **k: self.pinned

    def __exit__(self, *exc):
        self.tr.encode_frame = self.real


# ---------------------------------------------------------------------------
# phase 3c: the coordinate-major serving configuration (kernels 7 and 8)
# ---------------------------------------------------------------------------

SOA_CONFIGS = {"mode0": dict(VANERF_SOA_POINTS="0"),
               "mode1": dict(VANERF_SOA_POINTS="1"),
               "mode2": dict(VANERF_SOA_POINTS="2")}


def phase_soa_serving(model, b, dev):
    """One frame per configuration and round, the configurations in turns,
    the far tier on (the default): every output of mode 1 and mode 2 must
    EQUAL mode 0's, kernels 7 and 8 must take the place of A and B.

    The frames that are compared share one encode: two encodes of one
    frame differ in their last bits on the card (the encoders' cuDNN
    convolutions do not repeat), and through the fine sampler's guard that
    moves fine colours by ~2e-3 between two identical mode-0 frames.  The
    timed rounds encode for themselves."""
    import torch
    res = {name: dict(frame_ms=[]) for name in SOA_CONFIGS}
    outs = {}
    with shared_encode(model, b):
        for name, switches in SOA_CONFIGS.items():
            outs[name], _ms, counts = timed_frame(model, b, switches)
            res[name]["launches"] = counts
            soa = name != "mode0"
            for kern, on in (("knn_T", soa), ("mesh_query_T", soa),
                             ("knn", not soa), ("mesh_query", not soa)):
                check((counts[kern] > 0) == on, f"kernel {kern}: "
                      f"{counts[kern]} launches under {switches}")
    for _ in range(SOA_ROUNDS):
        for name, switches in SOA_CONFIGS.items():
            res[name]["frame_ms"].append(timed_frame(model, b, switches)[1])
    check(outs["mode0"]["alpha_fine"].max().item() > 0.2,
          "SoA phase: rays missed the hands")
    for name in ("mode1", "mode2"):
        worst = 0.0
        for k, v in outs["mode0"].items():
            if torch.is_tensor(v):
                if v.is_floating_point():
                    worst = max(worst,
                                (outs[name][k] - v).abs().max().item())
                check(torch.equal(outs[name][k], v),
                      f"{name}: {k} differs from mode 0")
        res[name]["max_abs_err"] = worst
    return res


# ---------------------------------------------------------------------------
# phase 3e: the culled nearest-vertex search on the serving path (kernel 9)
# ---------------------------------------------------------------------------

CULL_CONFIGS = {
    "default": dict(VANERF_KNN_CULL=""),
    "cull": dict(VANERF_KNN_CULL="1"),
    "soa2d": dict(VANERF_KNN_CULL="", VANERF_SOA_POINTS="1",
                  VANERF_BLOCK_2D="4,4,8"),
    "soa2d_cull": dict(VANERF_KNN_CULL="1", VANERF_SOA_POINTS="1",
                       VANERF_BLOCK_2D="4,4,8"),
}


def phase_knn_cull_serving(model, b, dev):
    """The 256^2 frame under VANERF_KNN_CULL=1, pixel-major and under
    VANERF_SOA_POINTS=1 VANERF_BLOCK_2D=4,4,8, in turns with the default
    frame: every output equal to the same layout's frame without the
    switch (the 2-D tiles mark other points far than the 1-D tiles, so the
    coordinate-major pair has its own reference); 32 launches of kernel 9
    (or 9 on (3, N)) a frame and none of B (or 8); kernel 9's visit share
    on each pass of a culled frame of both layouts."""
    import torch
    from vanerf_tpu_torch.ops import knn
    res = {name: dict(frame_ms=[]) for name in CULL_CONFIGS}
    outs = {}
    with shared_encode(model, b):
        for name, switches in CULL_CONFIGS.items():
            outs[name], _ms, counts = timed_frame(model, b, switches)
            res[name]["launches"] = counts
            on = {"default": "knn", "cull": "knn_culled", "soa2d": "knn_T",
                  "soa2d_cull": "knn_T_culled"}[name]
            for kern in ("knn", "knn_T", "knn_culled", "knn_T_culled"):
                check(counts[kern] == (32 if kern == on else 0),
                      f"kernel {kern}: {counts[kern]} launches under "
                      f"{switches}")
    for name, ref in (("cull", "default"), ("soa2d_cull", "soa2d")):
        for k, v in outs[ref].items():
            if torch.is_tensor(v):
                check(torch.equal(outs[name][k], v),
                      f"{name}: {k} differs from the {ref} frame")
    res["soa2d"]["max_abs_diff_from_default"] = max(
        (outs["soa2d"][k] - v).abs().max().item()
        for k, v in outs["default"].items()
        if torch.is_tensor(v) and v.is_floating_point())
    check(outs["default"]["alpha_fine"].max().item() > 0.2,
          "KNN_CULL phase: rays missed the hands")
    for _ in range(CULL_ROUNDS):
        for name in ("default", "cull", "soa2d_cull"):
            res[name]["frame_ms"].append(
                timed_frame(model, b, CULL_CONFIGS[name])[1])
    # kernel 9's visit share on each pass of one more culled frame of each
    # layout (not timed: every pass reads its visits back)
    for name, fn_name in (("cull", "nearest_vertex_d2_culled"),
                          ("soa2d_cull", "nearest_vertex_d2_T_culled")):
        real, shares = getattr(knn, fn_name), []

        def record(q, verts, visits=False, real=real, shares=shares):
            out = real(q, verts, visits=True)
            n_chunks = -(-verts.shape[0] // knn.VERT_CHUNK)
            shares.append(out[2].float().mean().item() / n_chunks)
            return out if visits else out[:2]

        setattr(knn, fn_name, record)
        try:
            timed_frame(model, b, CULL_CONFIGS[name])
        finally:
            setattr(knn, fn_name, real)
        check(len(shares) == 32, f"{name}: {len(shares)} passes recorded")
        res[name]["visit_share"] = dict(
            passes=len(shares), mean=sum(shares) / len(shares),
            min=min(shares), max=max(shares))
    return res


# ---------------------------------------------------------------------------
# phase 3f: the serving tiers FAR_SKIP / FAR_NET / FAR_TNET
# ---------------------------------------------------------------------------

TIER_CONFIGS = {
    "default": {},
    "skip1": dict(VANERF_FAR_SKIP="1"),
    "skip.5": dict(VANERF_FAR_SKIP="0.5"),
    "net.5": dict(VANERF_FAR_NET="0.5"),
    "tnet.5": dict(VANERF_FAR_TNET="0.5"),
}


def psnr(a, b) -> float:
    import math
    mse = (a - b).pow(2).mean().item()
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


_CPU_SIDE = []


def cpu_side(model, batch_np):
    """(model, frame, encode) on the CPU, made once: phases 3f and 4 render
    their CPU patches from them (the encoders at full width take most of a
    CPU patch's time); each render on the card encodes for itself."""
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    if not _CPU_SIDE:
        model_cpu, b_cpu = copy.deepcopy(model).cpu(), to_torch(batch_np,
                                                                "cpu")
        _CPU_SIDE.append((model_cpu, b_cpu, tr.encode_frame(model_cpu,
                                                            b_cpu)))
    return _CPU_SIDE[0]


def merge_order_flips(z_card, z_cpu):
    """(rays,) bool: the rays whose merged coarse + fine depths sort into
    another order on the card than on the CPU.

    The fine depths follow from the coarse network outputs, which round
    differently on the two devices, so a fine depth may equal a coarse one
    to the bit on one device and lie an ulp off it on the other.  The stable
    merge then swaps the two samples.  In the default render both carry the
    network's value at (nearly) one point and the swap moves nothing; under
    a tier one of them may be a dropped row, or the two may have inherited
    from different samples, and the swap hands the interval behind them to
    the other row.  A flip is certified: the swapped depths must lie within
    TIER_FLIP_MARGIN (relative) of each other on both devices."""
    import torch
    z_card, z_cpu = (z.reshape(-1, z.shape[-1]) for z in (z_card, z_cpu))
    o_card, o_cpu = (torch.argsort(z, dim=-1, stable=True)
                     for z in (z_card, z_cpu))
    differ = o_card != o_cpu
    for z in (z_card, z_cpu):
        gap = (torch.gather(z, 1, o_card) - torch.gather(z, 1, o_cpu)).abs()
        check((gap[differ] <= TIER_FLIP_MARGIN * z.abs().max()).all().item(),
              "merge order differs between card and CPU at distinct depths")
    return differ.any(1)


def phase_tier_serving(model, b, batch_np, dev):
    """The 256^2 frame under each serving tier, in turns with the default
    frame (far tier on in all).  The full budget (VANERF_FAR_SKIP=1) runs
    every sample through the compaction, so its frame is held as phase 3b
    holds the fused frames (the compacted rows reach the matrix products
    in another order and shape than the default render's); the half
    budgets must be finite, and one 8x8-ray patch of each must equal the CPU
    port's under the same switch to phase 4's tolerance: the coarse outputs
    on every ray, the fine outputs on every ray but those that
    :func:`merge_order_flips` certifies."""
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    res = {name: dict(frame_ms=[]) for name in TIER_CONFIGS}
    outs = {}
    with shared_encode(model, b):
        for name, switches in TIER_CONFIGS.items():
            outs[name], _ms, res[name]["launches"] = timed_frame(model, b,
                                                                 switches)
    for name, frame in outs.items():
        for k, v in frame.items():
            if torch.is_tensor(v) and v.is_floating_point():
                check(torch.isfinite(v).all().item(),
                      f"{name}: non-finite {k}")
        check(frame["alpha_fine"].max().item() > 0.2,
              f"{name}: rays missed the hands")
        res[name]["psnr_vs_default"] = psnr(frame["tex_fg_fine"],
                                            outs["default"]["tex_fg_fine"])
    # kernels 10 and D run once a pass, on the budget's rows
    for name in ("skip1", "skip.5", "net.5", "tnet.5"):
        check(res[name]["launches"]["row_gather"] == 32
              and res[name]["launches"]["interp_mxu"] == 32,
              f"{name}: launches {res[name]['launches']}")
    worst, share, abs_err = hold_to_fused_bounds("VANERF_FAR_SKIP=1",
                                                 [outs["skip1"]],
                                                 [outs["default"]])
    res["skip1"].update(of_bound=worst, share_outside=share,
                        max_abs_err=abs_err)
    res["pinned"] = pinned_fine_depths(
        model, b, reference={}, configs={"skip1": TIER_CONFIGS["skip1"]})
    # one patch of each half budget, card against CPU
    gen = torch.Generator().manual_seed(SEED + 5)
    model_cpu, b_cpu, cached_cpu = cpu_side(model, batch_np)
    grids = tr.mask_centered_grid(gen, b_cpu["tar_mask"][..., 0],
                                  TIER_CPU_RAYS, TIER_CPU_RAYS)
    kw = dict(out_h=TIER_CPU_RAYS, out_w=TIER_CPU_RAYS, sample_per_ray_c=S_C,
              sample_per_ray_f=S_F, compute_vis_map=False)
    merged, real_sort = [], tr.sort_by_key
    tr.sort_by_key = lambda key, *vals: (merged.append(key.cpu())
                                         or real_sort(key, *vals))
    try:
        for name in ("skip.5", "net.5", "tnet.5"):
            del merged[:]
            with env(**TIER_CONFIGS[name]):
                ops.reset_launches()
                got = tr.render_patch(model, b, grids=grids.to(dev), **kw)
                torch.cuda.synchronize()
                want = tr.render_patch(model_cpu, b_cpu, grids=grids,
                                       cached=cached_cpu, **kw)
            flipped = merge_order_flips(*merged)
            check(flipped.float().mean().item() <= TIER_FLIP_SHARE,
                  f"{name}: {int(flipped.sum())} rays merge in another order")
            errs = {}
            for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
                a, c = got[k].cpu(), want[k]
                err = (a - c).abs()
                errs[k] = err.max().item()
                outside = (err > TIER_CPU_ATOL + TIER_CPU_RTOL * c.abs()) \
                    .reshape(flipped.numel(), -1).any(1)
                if k.endswith("_fine"):
                    outside &= ~flipped
                    check(errs[k] <= FUSED_FINE_ABS,
                          f"{name}: {k} off by {errs[k]} on a flipped ray")
                check(not outside.any().item(),
                      f"{name}: card vs CPU mismatch in {k}: {errs[k]} on rays "
                      f"{outside.nonzero().flatten().tolist()}")
            res[name]["card_vs_cpu"] = errs
            res[name]["flipped_rays"] = int(flipped.sum())
    finally:
        tr.sort_by_key = real_sort
    for _ in range(TIER_ROUNDS):
        for name, switches in TIER_CONFIGS.items():
            res[name]["frame_ms"].append(timed_frame(model, b, switches)[1])
    return res


# ---------------------------------------------------------------------------
# phase 3h: the bfloat16 serving configuration (VANERF_COMPUTE_DTYPE)
# ---------------------------------------------------------------------------

# the far tier is on unfused (no switch) and off under the fused switches,
# as in the JAX package
BF16_CONFIGS = {"unfused": {}, "level1": dict(VANERF_FUSED_MLP="1"),
                "level2": dict(VANERF_FUSED_MLP="2")}
BF16_KERNELS = {"unfused": ("interp_mxu_bf16", "row_gather_bf16"),
                "level1": ("interp_mxu_bf16", "row_gather_bf16",
                           "fused_geo_mlp_bf16"),
                "level2": ("interp_mxu_bf16", "row_gather_bf16",
                           "fused_query_mlp_bf16")}
# the float32 forms of the same kernels: none may run on a bfloat16 frame
# (no float32 fallback), and no bfloat16 form on a float32 frame
F32_FORMS = ("interp_mxu", "row_gather", "fused_geo_mlp", "fused_query_mlp")


def phase_bf16_serving(model, model16, b, batch_np, dev, cfg, num_v):
    """The 256^2 frame at full width in bfloat16, unfused and at fused
    levels 1 and 2, each in turns with the float32 frame under the same
    switches; PSNR of the bfloat16 frame against the float32 one; one
    8x8-ray patch of each configuration on the card against the CPU
    port's in bfloat16."""
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    bf16_names = tuple(n + "_bf16" for n in F32_FORMS)
    res = {name: dict(frame_ms=[], f32_frame_ms=[]) for name in BF16_CONFIGS}
    for rnd in range(BF16_ROUNDS):
        for name, switches in BF16_CONFIGS.items():
            frames = {}
            for tag, m in (("f32", model), ("bf16", model16)):
                with env(**switches):
                    ops.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    frames[tag] = tr.render_full_image(
                        m, b, level=3, sample_per_ray_c=S_C,
                        sample_per_ray_f=S_F)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    counts = ops.launch_counts()
                res[name]["frame_ms" if tag == "bf16"
                          else "f32_frame_ms"].append(ms)
                if rnd:
                    continue
                if tag == "bf16":
                    res[name]["launches"] = counts
                    for kern in BF16_KERNELS[name]:
                        check(counts[kern] > 0, f"kernel {kern} was not "
                              f"launched by the bfloat16 frame ({name})")
                    for kern in F32_FORMS:
                        check(counts[kern] == 0, f"the float32 {kern} ran "
                              f"on the bfloat16 frame ({name})")
                else:
                    for kern in bf16_names:
                        check(counts[kern] == 0, f"{kern} ran on the "
                              f"float32 frame ({name})")
                for k in ("mesh_query", "knn", "rasterize"):
                    check(counts[k] > 0, f"kernel {k} not launched ({name})")
            if rnd:
                continue
            f16, f32 = frames["bf16"], frames["f32"]
            for k, v in f16.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    check(v.dtype == torch.float32 and
                          torch.isfinite(v).all().item(),
                          f"bfloat16 frame ({name}): {k} {v.dtype}")
            check(f16["alpha_fine"].max().item() > 0.2,
                  f"bfloat16 frame ({name}): rays missed the hands")
            res[name]["psnr_vs_f32"] = psnr(f16["tex_fg_fine"],
                                            f32["tex_fg_fine"])
            res[name]["max_abs_vs_f32"] = {
                k: (f16[k] - f32[k]).abs().max().item()
                for k in ("tex_fg_fine", "alpha_fine")}
    # the card's bfloat16 patch against the CPU port's (plain twins)
    model_cpu, b_cpu, cached_cpu = cpu_side(model, batch_np)
    model16_cpu = bf16_model(model_cpu, cfg, num_v)
    grids = tr.mask_centered_grid(torch.Generator().manual_seed(SEED + 5),
                                  b_cpu["tar_mask"][..., 0], BF16_CPU_RAYS,
                                  BF16_CPU_RAYS)
    kw = dict(out_h=BF16_CPU_RAYS, out_w=BF16_CPU_RAYS, sample_per_ray_c=S_C,
              sample_per_ray_f=S_F, compute_vis_map=False)
    keys = ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine")
    # the card renders from the CPU's encode: the float32 encoders agree to
    # float32's tolerance, and the cast to bfloat16 would turn those last
    # bits into bfloat16 units in a few percent of the maps' values, whose
    # effect is no rounding of the query's
    cached_dev = tuple([t.to(dev) for t in c] if isinstance(c, list)
                       else c.to(dev) for c in cached_cpu)

    def rms(x):
        return x.double().pow(2).mean().sqrt().item()

    real = tr.importance_sample
    for name, switches in BF16_CONFIGS.items():
        # the four patches take the CPU bfloat16 patch's fine depths: the
        # fine samples follow the coarse weights discontinuously, and a
        # moved sample is no rounding of the network's
        kept = []
        try:
            with env(**switches):
                tr.importance_sample = (
                    lambda *a, **k: kept.append(real(*a, **k)) or kept[-1])
                cpu16 = tr.render_patch(model16_cpu, b_cpu, grids=grids,
                                        cached=cached_cpu, **kw)
                tr.importance_sample = lambda *a, **k: kept[0]
                cpu32 = tr.render_patch(model_cpu, b_cpu, grids=grids,
                                        cached=cached_cpu, **kw)
                tr.importance_sample = lambda *a, **k: kept[0].to(dev)
                card = tr.render_patch(model16, b, grids=grids.to(dev),
                                       cached=cached_dev, **kw)
                card32 = tr.render_patch(model, b, grids=grids.to(dev),
                                         cached=cached_dev, **kw)
                torch.cuda.synchronize()
        finally:
            tr.importance_sample = real
        worst, rms_of_s = {}, {}
        for k in keys:
            a, a32 = card[k].cpu(), card32[k].cpu()
            c16, c32 = cpu16[k], cpu32[k]
            spread = (c16 - c32).abs().max().item()
            bound = 2.0 * spread + 1e-4 + 1e-3 * c16.abs()
            worst[k] = ((a - c16).abs() / bound).max().item()
            check(worst[k] <= 1.0, f"bfloat16 {name}: card vs CPU {k} at "
                  f"{worst[k]:.3g} x (2 x {spread:.3g} + 1e-4 + 1e-3 |x|)")
            s_rms, e_rms = rms(c16 - c32), rms(a32 - c32)
            rbound = s_rms / 2 + 2 * e_rms
            err, ctrl = rms(a - c16), rms(a32 - c16)
            rms_of_s[k] = dict(S=s_rms, E=e_rms, err=err, bound=rbound,
                               control=ctrl)
            check(err <= rbound, f"bfloat16 {name}: card vs CPU {k}: RMS "
                  f"error {err:.3g} > S / 2 + 2 E = {rbound:.3g} (S "
                  f"{s_rms:.3g}, E {e_rms:.3g})")
            if not k.startswith("alpha"):
                check(ctrl > rbound, f"bfloat16 {name}: the card's float32 "
                      f"{k} lies within the RMS bound ({ctrl:.3g} <= "
                      f"{rbound:.3g})")
        check(cpu16["alpha_fine"].max().item() > 0.2,
              f"bfloat16 {name}: the CPU patch missed")
        res[name]["card_vs_cpu_of_bound"] = worst
        res[name]["card_vs_cpu_rms"] = rms_of_s
    return res



# ---------------------------------------------------------------------------
# phase 3i: the tile group (render_full_image(tile_group=G)) and the batched
# kernels B / 8, A / 7, D and 10
# ---------------------------------------------------------------------------

TILE_GROUPS = (1, 4, 16)
TILE_GROUP_ROUNDS = 2
# the batches the kernels are held at: two different frames x 2 tiles, and
# one frame's group of 16 tiles (the G = 16 frame's coarse pass)
BATCH_CASES = {"two_frames": (2, 2), "g16": (1, 16)}
BENCH_ROUNDS = 2


def stack_frames(batches):
    """Frames as one batch of Bf frames (the faces and the depth range
    shared)."""
    import torch
    return {k: (torch.cat([b[k] for b in batches])
                if torch.is_tensor(v) and v.dim() > 0 and k != "faces"
                else v) for k, v in batches[0].items()}


def group_inputs(model, fb, G: int):
    """The coarse pass of the first G-tile group of the 256^2 frames ``fb``
    (Bf frames) at level 3: element t Bf + b is frame b at the t-th stride
    offset.  Returns the points (E, N, 3), the frames' vertices, their
    prepared meshes, their coarse geometry maps and the projected (u, v)
    each element's points take on its frame's maps."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.models.vanerf import per_element
    Bf = fb["tar_k"].shape[0]
    E = G * Bf
    s = 4
    offsets = [(j, i) for i in range(s) for j in range(s)][:G]
    strides = torch.tensor([[o] * Bf for o in offsets],
                           dtype=torch.float32).reshape(E, 2)
    dev = fb["src_img"].device
    grids = tr.strided_grid(E, H, W, 3, strides, device=dev)
    eb = dict(fb, **{k: per_element(fb[k], E)
                     for k in ("tar_k", "tar_rt", "bounds")})
    cam_pos, cam_rays, z = tr.patch_rays(eb, grids, S_C)
    pts = (cam_pos[:, :, None] + cam_rays[:, :, None] * z[..., None]) \
        .reshape(E, -1, 3).contiguous()
    feat_geo, _ft, vert_vis = tr.encode_frame(model, fb)
    meshes = tr.prepare_frame_meshes(fb, vert_vis)
    krt = per_element(fb["src_krt"], E)
    vh = pts @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
    xy = vh[..., :2] / vh[..., 2:3]
    uv = torch.stack([2.0 * xy[..., 0] / (W - 1.0) - 1.0,
                      2.0 * xy[..., 1] / (H - 1.0) - 1.0], -1).contiguous()
    return (pts, fb["verts"].contiguous(), meshes,
            feat_geo[0].contiguous(), uv)


def batched_kernel_case(model, fb, G: int, timed: bool):
    """Kernels B, 8, A, 7 (far tier on, 16-ray x 8-sample tiles), D and 10
    (float32 and bfloat16) launched once over the G x Bf elements of
    ``group_inputs``, each equal to the bit to the elements' own launches
    (the mesh query in every output, its visits included).  With
    ``timed``: each batched launch's device time (a CUDA graph) beside its
    element 0's alone and the batched launch's bound."""
    import torch
    from vanerf_tpu_torch.ops import _cuda, interp_mxu, knn, mesh_query
    pts, verts, meshes, geo, uv = group_inputs(model, fb, G)
    E, N = pts.shape[:2]
    Bf = verts.shape[0]
    V = verts.shape[1]
    dev = pts.device
    frame = _cuda.batch_index(E, Bf, dev)
    p_c = (pts - meshes["center"][frame][:, None]).contiguous()
    tiles = mesh_query.tile_geometry(N, S_C)
    far2 = 0.02 ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    table = torch.randn(Bf, V, 204, generator=gen, device=dev)
    idx, d2 = knn.nearest_vertex_d2(pts, verts)
    inputs = {
        "knn": (knn.nearest_vertex_d2, (pts, verts)),
        "knn_T": (knn.nearest_vertex_d2_T,
                  (pts.transpose(1, 2).contiguous(), verts)),
        "mesh_query": (
            lambda *a: mesh_query.point_mesh_query_vis_culled(
                *a, tiles=tiles, far2=far2, visits=True),
            (p_c, meshes, d2)),
        "mesh_query_T": (
            lambda *a: mesh_query.point_mesh_query_vis_culled_T(
                *a, tiles=tiles, far2=far2, visits=True),
            (p_c.transpose(1, 2).contiguous(), meshes, d2)),
        "interp_mxu": (interp_mxu.interp_cuda, (geo, uv)),
        "interp_mxu_bf16": (interp_mxu.interp_cuda,
                            (geo.to(torch.bfloat16), uv)),
        "row_gather": (interp_mxu.row_gather_cuda, (table, idx)),
        "row_gather_bf16": (interp_mxu.row_gather_cuda,
                            (table.to(torch.bfloat16), idx)),
    }
    res = {}
    for name, (fn, args) in inputs.items():
        def element(e, args=args):
            """Element e's own inputs: its rows of the batched ones, its
            frame's of the stacked ones."""
            out = []
            for a in args:
                if isinstance(a, dict):
                    out.append(mesh_query.mesh_element(a, e % Bf))
                elif a.shape[0] == E:
                    out.append(a[e])
                else:
                    out.append(a[e % Bf])
            return tuple(out)

        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        for e in range(E):
            one = fn(*element(e))
            one = one if isinstance(one, tuple) else (one,)
            for k, (a, b) in enumerate(zip(got, one)):
                check((a is None and b is None) or torch.equal(a[e], b),
                      f"{name}: batched output {k} of element {e} differs "
                      f"from its own launch ({E} elements of {Bf} frames)")
        torch.cuda.synchronize()
        r = res[name] = {}
        if not timed:
            continue
        if name.startswith("knn"):
            bound = least_time(nbytes(pts, verts, *got), KNN_OPS * E * N * V)
        elif name.startswith("mesh_query"):
            vis = got[-1]
            chunk = meshes["chunk"]
            tile_p = mesh_query.cull_sizes()[0]
            check(meshes["table"].shape[1] % chunk == 0, "ragged chunks")
            pairs = vis.sum((0, 1)).tolist()
            bound = least_time(
                nbytes(p_c, meshes["table"], meshes["cbox"],
                       meshes["sphere"], d2, *[t for t in got[:5]
                                               if t is not None]),
                (pairs[0] * MESH_DIST_OPS + pairs[1] * MESH_CROSS_OPS)
                * chunk * tile_p)
            r.update(dist_visit_share=vis[..., 0].float().mean().item()
                     / meshes["cbox"].shape[1])
        elif name.startswith("interp"):
            C = geo.shape[-1]
            bound = least_time(nbytes(args[0], uv, got[0]),
                               E * N * (20 + 7 * C))
        else:
            bound = least_time(nbytes(args[0], idx, got[0]), 0)
        reps = 3 if name.startswith("row_gather") else 10
        r.update(elements=E, frames=Bf,
                 batch_device_ms=graph_ms(lambda: fn(*args), reps),
                 element_device_ms=graph_ms(lambda: fn(*element(0))),
                 batch_bound_ms=bound["bound_ms"],
                 batch_bound_by=bound["bound_by"])
    return res


def phase_tile_group(model, batches, cfg, dev):
    """Phase 3i: the batched kernels on two frames and on a 16-tile group,
    each equal to its per-element launches; then the 256^2 frame at each G
    of TILE_GROUPS in turns on one encode (ms, peak memory, launches and,
    under torch.profiler, device ops and busy time a frame), each G frame
    held to the G = 1 frame as phase 3b holds the fused frames; then one
    short run of the benchmark entry point's serving and training readings
    (``vanerf_tpu_torch.bench.serve`` / ``train``) on this model and
    frame, the bench's own shapes."""
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import renderer as tr
    res = {"kernels": {}}
    for case, (n_frames, G) in BATCH_CASES.items():
        res["kernels"][case] = batched_kernel_case(
            model, stack_frames(batches[:n_frames]), G, timed=case == "g16")
    b = batches[0]
    frames = {G: dict(frame_ms=[]) for G in TILE_GROUPS}
    outs = {}

    def frame(G):
        return tr.render_full_image(model, b, level=3, sample_per_ray_c=S_C,
                                    sample_per_ray_f=S_F, tile_group=G)

    with shared_encode(model, b):
        for G in TILE_GROUPS:
            ops.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            outs[G] = frame(G)
            torch.cuda.synchronize()
            frames[G].update(first_ms=(time.perf_counter() - t0) * 1e3,
                             peak_bytes=torch.cuda.max_memory_allocated(dev),
                             launches=ops.launch_counts())
            want = 2 * 16 // G
            for name in ("knn", "mesh_query", "interp_mxu", "row_gather"):
                got = frames[G]["launches"][name]
                check(got == want, f"tile_group={G}: {got} launches of "
                      f"{name} a frame, not 2 s^2 / G = {want}")
        for _ in range(TILE_GROUP_ROUNDS):
            for G in TILE_GROUPS:
                frames[G]["frame_ms"].append(bench.timed(lambda: frame(G),
                                                         dev))
        for G in TILE_GROUPS:
            frames[G].update(bench.device_profile(lambda: frame(G), dev))
    for G in TILE_GROUPS[1:]:
        worst, share, abs_err = hold_to_fused_bounds(
            f"tile_group={G}", [outs[G]], [outs[1]])
        frames[G].update(of_bound=worst, share_outside=share,
                         max_abs_err=abs_err)
    check(outs[1]["alpha_fine"].max().item() > 0.2,
          "tile group phase: rays missed the hands")
    res["frames"] = frames
    res["bench_serve"] = dict(
        bench.serve(model, b, bench.Shapes(), tile_group=TILE_GROUPS[-1],
                    rounds=BENCH_ROUNDS, device=dev), **bench.card())
    res["bench_train"] = dict(
        bench.train(model, b, cfg, rounds=BENCH_ROUNDS - 1, device=dev),
        **bench.card())
    return res


# ---------------------------------------------------------------------------
# phase 3d: the exact mesh-query API (kernels 5 and 6)
# ---------------------------------------------------------------------------

def phase_mesh_api(model, b, dev):
    """``cal_vis_sdf_fast`` under both VANERF_WINDING values,
    ``point_mesh_sdf`` and ``cal_vis_sdf`` on the points of one 64x64x64
    pass (the first strided tile of the full image, which crosses both
    hands) against the renderer's query (kernels B and A, far tier off)."""
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.ops import knn, mesh_query
    pts, mesh, _geo, _uv, _grids, vert_vis = main_path_points(
        model, b, tr.strided_grid(1, H, W, 3, [[0, 0]], device=dev))
    verts, faces = b["verts"][0].contiguous(), b["faces"]
    _idx, ub = knn.nearest_vertex_d2(pts, verts)
    sdf_r, qvis_r, _far = mesh_query.cal_vis_sdf_prepared(mesh, pts, ub,
                                                          n_samples=S_C)
    check(1e-3 < (sdf_r < 0).float().mean().item() < 0.5,
          "the pass's points should lie inside and outside the hands")
    ops.reset_launches()
    res = {}

    p_c = pts - mesh["center"]

    def hold(tag, sdf, qvis=None):
        # the renderer's sign counts crossings of the centred points: it may
        # differ only where that ray grazes an edge to within rounding
        differ = (sdf < 0) != (sdf_r < 0)
        n_differ = int(differ.sum())
        graze = (ray_edge_margin(p_c[differ], mesh["table"]).max().item()
                 if n_differ else 0.0)
        check(n_differ <= GRAZE_SHARE * pts.shape[0]
              and graze <= GRAZE_MARGIN,
              f"{tag}: {n_differ} signs differ from the renderer's query, "
              f"the farthest {graze:.3g} (barycentric units) from an edge")
        rel = ((sdf.abs() - sdf_r.abs()).abs() / sdf_r.abs()).max().item()
        check(rel <= API_SDF_RTOL, f"{tag}: |sdf| off by {rel}")
        res[tag] = dict(sdf_rel_err=rel, signs_differ=n_differ,
                        their_edge_margin=graze,
                        inside_share=(sdf < 0).float().mean().item())
        if qvis is not None:
            agree = (qvis == qvis_r).float().mean().item()
            check(agree >= API_QVIS_AGREE, f"{tag}: visibility agrees on "
                  f"{agree}")
            res[tag]["qvis_agree"] = agree

    for winding in ("ray", "solid_angle"):
        with env(VANERF_WINDING=winding):
            t_ms = cuda_ms(lambda: mesh_query.cal_vis_sdf_fast(
                verts, faces, pts, vert_vis), 2, warmup=0)
            sdf, qvis = mesh_query.cal_vis_sdf_fast(verts, faces, pts,
                                                    vert_vis)
        hold(f"cal_vis_sdf_fast[{winding}]", sdf, qvis)
        res[f"cal_vis_sdf_fast[{winding}]"]["ms"] = t_ms
    sdf, face_idx = mesh_query.point_mesh_sdf(verts, faces, pts)
    hold("point_mesh_sdf", sdf)
    check(0 <= int(face_idx.min()) and int(face_idx.max()) < faces.shape[0],
          "point_mesh_sdf: face index out of range")
    sdf_c, qvis_c, cface = mesh_query.cal_vis_sdf(verts, faces, pts, vert_vis)
    hold("cal_vis_sdf", sdf_c, qvis_c)
    check(cface.shape == (pts.shape[0], 3), "cal_vis_sdf closest-face shape")
    torch.cuda.synchronize()
    res["launches"] = ops.launch_counts()
    for name in ("mesh_query_brute", "mesh_query_vis_brute"):
        check(res["launches"][name] > 0,
              f"kernel {name} was not launched by the exact API")
    return res


# ---------------------------------------------------------------------------
# phase 4: full chain, card (kernels) against CPU (plain twins)
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(model, batch_np, dev):
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    gen = torch.Generator().manual_seed(SEED + 2)
    model_cpu, b_cpu, cached_cpu = cpu_side(model, batch_np)
    grids = tr.mask_centered_grid(gen, b_cpu["tar_mask"][..., 0], 16, 16)
    out_gpu = tr.render_patch(model, to_torch(batch_np, dev),
                              grids=grids.to(dev), out_h=16, out_w=16,
                              sample_per_ray_c=S_C, sample_per_ray_f=S_F,
                              compute_vis_map=False)
    torch.cuda.synchronize()
    out_cpu = tr.render_patch(model_cpu, b_cpu, grids=grids, out_h=16,
                              out_w=16, sample_per_ray_c=S_C,
                              sample_per_ray_f=S_F, compute_vis_map=False,
                              cached=cached_cpu)
    errs = {}
    for k in ("tex_fg_fine", "alpha_fine"):
        a, c = out_gpu[k].cpu(), out_cpu[k]
        errs[k] = (a - c).abs().max().item()
        check(torch.allclose(a, c, rtol=1e-3, atol=1e-4),
              f"card vs CPU mismatch in {k}: {errs[k]}")
    check(out_cpu["alpha_fine"].max().item() > 0.2, "16x16 patch missed")
    return errs


# ---------------------------------------------------------------------------
# phase 5: the GAN train step at full width
# ---------------------------------------------------------------------------

def train_parts(model, dev):
    """A copy of the generator, a seeded discriminator and the seed-19 VGG,
    on ``dev``."""
    import torch
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, init_like_flax
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(SEED + 1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    return copy.deepcopy(model).to(dev), disc.to(dev), vgg.to(dev)


class Trainer:
    """Faithful GAN steps of a copy of ``model`` from the seeded weights
    and draws, as a user takes them (``create_train_state`` /
    ``make_train_step``), one :meth:`step` at a time, so that two trainers
    can step in turns: each step's time, its launches and the peak device
    memory, per trainer."""

    def __init__(self, model, batch, cfg, dev, seed: int = SEED + 3,
                 n_views: int = 1):
        import torch
        from vanerf_tpu_torch.training import (create_train_state,
                                               make_train_step)
        self.gen_model, self.disc, vgg = train_parts(model, dev)
        self.state = create_train_state(self.gen_model, self.disc, cfg)
        self.step_fn = make_train_step(self.gen_model, self.disc, cfg, vgg,
                                       n_views=n_views)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.batch, self.dev = batch, dev
        self.step_ms, self.logs, self.launches, self.peak = [], [], {}, 0

    def step(self):
        import torch
        from vanerf_tpu_torch import ops
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        self.logs.append(self.step_fn(self.state, self.batch, self.gen))
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in ops.launch_counts().items():
            self.launches[k] = self.launches.get(k, 0) + v
        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))

    def result(self) -> dict:
        """Every loss and parameter finite; the readings."""
        import torch
        for i, lg in enumerate(self.logs):
            for k, v in lg.items():
                check(bool(torch.isfinite(v).all()), f"step {i}: {k} = {v}")
        for net in (self.gen_model, self.disc):
            for name, p in net.named_parameters():
                check(bool(torch.isfinite(p).all()), f"non-finite {name}")
        return dict(step_ms=self.step_ms,
                    ms_per_step=sum(self.step_ms[1:])
                    / max(len(self.step_ms) - 1, 1),
                    peak_bytes=self.peak, launches=dict(self.launches),
                    logs=[{k: v.item() for k, v in lg.items()}
                          for lg in self.logs])


def check_train_launches(launches, steps, fused_level, soa, bf16):
    """The kernels a training run must (and must not) have launched.  The
    G render builds a graph; the D render does not.  Under
    VANERF_FUSED_TRAIN both renders' forwards run without one."""
    sfx = "_bf16" if bf16 else ""
    # two renders a step, two passes each: A and B, or 7 and 8 under SoA
    query = (("mesh_query_T", "knn_T") if soa else ("mesh_query", "knn"))
    for name in ("mesh_query", "knn", "mesh_query_T", "knn_T"):
        check(launches[name] == (4 * steps if name in query else 0),
              f"kernel {name}: {launches[name]} launches in training under "
              f"VANERF_SOA_POINTS={soa}")
    for name in ("rasterize", "onehot_scatter" + sfx):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the training path")
    # kernel D samples only where no graph is built at inference (as in the
    # JAX package): the fused forwards, never a training query
    check(fused_level > 0 or launches["interp_mxu" + sfx] == 0,
          "kernel D ran under training")
    # the KNN rows with a table gradient go through take_rows; a pass
    # without a graph takes kernel 10: the D render's two, and under
    # VANERF_FUSED_TRAIN the G render's two as well
    want = (4 if fused_level else 2) * steps
    check(launches["row_gather" + sfx] == want,
          f"kernel 10: {launches['row_gather' + sfx]} launches in training, "
          f"not {want}")
    fused = {0: None, 1: "fused_geo_mlp", 2: "fused_query_mlp"}[fused_level]
    for name in ("fused_geo_mlp", "fused_query_mlp"):
        # two renders a step, two passes each
        check(launches[name + sfx] == (4 * steps if name == fused else 0),
              f"kernel {name + sfx}: {launches[name + sfx]} launches under "
              f"VANERF_FUSED_TRAIN={fused_level}")
    if bf16:    # no float32 form of D, 10, 11 or 12 in a bfloat16 step
        for name in ("interp_mxu", "row_gather", "fused_geo_mlp",
                     "fused_query_mlp"):
            check(launches[name] == 0, f"the float32 {name} ran in a "
                  "bfloat16 training step")


def phase_train(model, batch, cfg, dev, fused_level: int = 0, soa: int = 0,
                steps: int = TRAIN_STEPS):
    """``steps`` faithful GAN steps from the seeded weights and draws; with
    ``fused_level`` under VANERF_FUSED_TRAIN=<level>, with ``soa`` under
    VANERF_SOA_POINTS=<mode>."""
    with env(VANERF_FUSED_TRAIN=str(fused_level),
             VANERF_SOA_POINTS=str(soa)):
        tr = Trainer(model, batch, cfg, dev)
        for _ in range(steps):
            tr.step()
        res = tr.result()
    check_train_launches(res["launches"], steps, fused_level, soa,
                         model.compute_dtype == "bfloat16")
    return res


def phase_train_bf16_turns(model, model16, batch, cfg, dev,
                           steps: int = TRAIN_STEPS):
    """Phase 5d: ``steps`` faithful GAN steps of the bfloat16 model in
    turns with as many of the float32 model, each from the same seeded
    weights and draws; the launches of the bfloat16 steps."""
    runs = {"float32": Trainer(model, batch, cfg, dev),
            "bfloat16": Trainer(model16, batch, cfg, dev)}
    for _ in range(steps):
        for tr in runs.values():
            tr.step()
    res = {k: tr.result() for k, tr in runs.items()}
    check_train_launches(res["bfloat16"]["launches"], steps, 0, 0, True)
    check_train_launches(res["float32"]["launches"], steps, 0, 0, False)
    return res


def native_gather_accumulation(dev) -> str:
    """What the backward of torch's native gather from a bfloat16 table
    (the route of a table above 8,192 rows) does on the card: 300 ones into
    one row sum to 300 in float32 and to 256 in bfloat16 adds."""
    import torch
    t = torch.zeros(4, 3, dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    idx = torch.zeros(300, dtype=torch.long, device=dev)
    (g,) = torch.autograd.grad(t[idx], t, torch.ones(300, 3,
                                                     dtype=torch.bfloat16,
                                                     device=dev))
    v = g[0, 0].item()
    return (f"{v:g}: " + ("a float32 sum rounded once" if v == 300.0 else
                         "bfloat16 adds" if v == 256.0 else "neither"))


def with_torch_pads(model):
    """A copy of ``model`` whose replication pads and adaptive pools are
    torch's own modules again (``nn.ReplicationPad2d``,
    ``nn.AdaptiveAvgPool2d``), whose CUDA backwards add with atomics."""
    import torch.nn as nn
    from vanerf_tpu_torch.models import blocks, fusion
    model = copy.deepcopy(model)
    for mod in list(model.modules()):
        for name, child in mod.named_children():
            if isinstance(child, blocks.ReplicationPad2d):
                setattr(mod, name, nn.ReplicationPad2d(child.p))
            elif isinstance(child, fusion.AdaptiveAvgPool2d):
                setattr(mod, name, nn.AdaptiveAvgPool2d(child.out))
    return model


class unpinned:
    """For the length of a ``with`` block the train step runs without its
    pin to cuDNN's deterministic algorithms
    (``training/train_step.py::deterministic``)."""

    def __enter__(self):
        import contextlib
        from vanerf_tpu_torch.training import train_step
        self.real = train_step.deterministic
        train_step.deterministic = contextlib.nullcontext

    def __exit__(self, *exc):
        from vanerf_tpu_torch.training import train_step
        train_step.deterministic = self.real


def bits_sum(t):
    """An order-free exact digest of a tensor's bits: the int64 sum of its
    elements read as integers of their width."""
    import torch
    view = {4: torch.int32, 2: torch.int16}[t.element_size()]
    return t.detach().contiguous().view(view).to(torch.int64).sum()


class step_trace:
    """Forward hooks on every leaf module of ``nets``: the digest of each
    output tensor in call order, and of the gradient that reaches it, in
    the order the backward produces them; the digests of the gradients the
    optimizers of ``tr`` take."""

    def __init__(self, tr):
        self.tr, self.fwd, self.bwd, self.grads = tr, [], [], {}

    def __enter__(self):
        def hook(_m, _i, out, name):
            for k, o in enumerate(out if isinstance(out, (tuple, list))
                                  else (out,)):
                if torch_is_float(o):
                    self.fwd.append((name, bits_sum(o)))
                    if o.requires_grad:
                        o.register_hook(lambda g, n=f"{name}[{k}]":
                                        self.bwd.append((n, bits_sum(g))))
        self.hooks = [m.register_forward_hook(
            lambda mm, i, o, n=f"{tag}.{name}": hook(mm, i, o, n))
            for tag, net in (("G", self.tr.gen_model), ("D", self.tr.disc))
            for name, m in net.named_modules() if not list(m.children())]
        self.real = {}
        for tag, opt in (("G", self.tr.state.opt_g),
                         ("D", self.tr.state.opt_d)):
            self.real[tag] = opt.step

            def step(grads, tag=tag, opt=opt):
                self.grads[tag] = [bits_sum(g) if g is not None else None
                                   for g in grads]
                self.real[tag](grads)
            opt.step = step
        return self

    def __exit__(self, *exc):
        for hk in self.hooks:
            hk.remove()
        self.tr.state.opt_g.step = self.real["G"]
        self.tr.state.opt_d.step = self.real["D"]


def torch_is_float(o) -> bool:
    import torch
    return torch.is_tensor(o) and o.is_floating_point()


def repeat_step(m, batch, cfg, dev, n_views: int = 1) -> dict:
    """One step each of two trainers from one deep-copied state with one
    seed of draws: the logs and the generator's and discriminator's updated
    parameters that differ; where they do, the first leaf module whose
    output differs, the first gradient (in backward order) that reaches a
    leaf module's output differently, and the parameter gradients the
    optimizers took differently."""
    import torch
    a, b = (Trainer(m, batch, cfg, dev, n_views=n_views) for _ in range(2))
    with step_trace(a) as ta:
        a.step()
    with step_trace(b) as tb:
        b.step()
    logs = [k for k in a.logs[0]
            if not torch.equal(a.logs[0][k], b.logs[0][k])]
    names = {tag: [n for n, _ in net.named_parameters()]
             for tag, net in (("G", a.gen_model), ("D", a.disc))}
    params = [f"{tag}.{n}" for tag, na, nb in
              (("G", a.gen_model, b.gen_model), ("D", a.disc, b.disc))
              for (n, pa), (_, pb) in zip(na.named_parameters(),
                                          nb.named_parameters())
              if not torch.equal(pa, pb)]

    def first(x, y):
        return next((f"{na} (#{i} of {len(x)})"
                     for i, ((na, u), (nb, v)) in enumerate(zip(x, y))
                     if na != nb or not torch.equal(u, v)), None)

    grads = {tag: [n for n, u, v in zip(names[tag], ta.grads[tag],
                                        tb.grads[tag])
                   if (u is None) != (v is None)
                   or (u is not None and not torch.equal(u, v))]
             for tag in ("G", "D")}
    n = sum(len(v) for v in names.values())
    return dict(logs_differ=logs, params_differ=params, n_params=n,
                bit_equal=not logs and not params,
                first_output_differing=first(ta.fwd, tb.fwd),
                first_gradient_differing=first(ta.bwd, tb.bwd),
                leaf_outputs=len(ta.fwd), grads_differ=grads)


def phase_train_repeat(models, batch, cfg, dev,
                       rounds: int = REPEAT_ROUNDS) -> dict:
    """Phase 5f, for each model of ``models`` (float32, bfloat16): two
    steps from one state and one seed of draws, compared bit for bit, as
    the step runs (pinned) and "unpinned": without the cuDNN pin and with
    torch's replication pads and adaptive pools (``with_torch_pads``);
    the ops torch flags as without a deterministic implementation in one
    more step (``torch.use_deterministic_algorithms(True,
    warn_only=True)``); the cost of the three, ``rounds`` steps pinned and
    unpinned in turns."""
    import statistics
    import warnings
    import torch
    out = {}
    for cdt, m in models.items():
        r = dict(pinned=repeat_step(m, batch, cfg, dev))
        free_model = with_torch_pads(m)
        with unpinned():
            r["unpinned"] = repeat_step(free_model, batch, cfg, dev)
        c = Trainer(m, batch, cfg, dev)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                c.step()
        finally:
            torch.use_deterministic_algorithms(False)
        r["flagged_ops"] = sorted({
            str(w.message).split(" does not have a deterministic")[0]
            for w in caught if "deterministic" in str(w.message)})
        pin = Trainer(m, batch, cfg, dev)
        free = Trainer(free_model, batch, cfg, dev)
        for _ in range(rounds):
            pin.step()
            with unpinned():
                free.step()
        r["ms_pinned"], r["ms_unpinned"] = pin.step_ms, free.step_ms
        r["median_ms_pinned"] = statistics.median(pin.step_ms[1:]
                                                  or pin.step_ms)
        r["median_ms_unpinned"] = statistics.median(free.step_ms[1:]
                                                    or free.step_ms)
        out[cdt] = r
    return out


# ---------------------------------------------------------------------------
# phase 6: one G-loss gradient, card (kernels) against CPU (plain twins)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 7: the entry point, ``python -m vanerf_tpu_torch.train``, in process
# ---------------------------------------------------------------------------

def tensors_equal(a, b, path="") -> list:
    """The paths at which two nested containers of tensors differ."""
    import torch
    if torch.is_tensor(a) or torch.is_tensor(b):
        same = (torch.is_tensor(a) and torch.is_tensor(b)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [path + "{keys}"]
        return [p for k in a for p in tensors_equal(a[k], b[k],
                                                    f"{path}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [path + "[len]"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in tensors_equal(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def phase_entry_point(dev) -> dict:
    """``vanerf_tpu_torch.train.main`` at full width on the 256^2 subdiv-3
    fixture of one frame (8 cameras: 8 steps an epoch), validation every
    half epoch: ``--fast_dev_run``; one epoch of ``fit`` with the training
    launches counted against its steps (validation's and the training
    dataset's draws subtracted) and
    ``val_fn`` run twice; a second invocation that resumes, its state equal
    to the bit to the saved one; ``--run_val --model_ckpt`` on that
    checkpoint directory, its report finite."""
    import shutil
    import torch
    from vanerf_tpu_torch import eval_loop, ops, training
    from vanerf_tpu_torch import train as entry
    from vanerf_tpu_torch.data import synthetic
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.training.checkpoints import state_blob
    out_dir = os.path.join(REPO, "build", "entry_point")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = default_cfg()
    cfg["dataset"]["synthetic_cfg"] = {"H": H, "W": W, "subdiv": SUBDIV,
                                       "n_frames": 1}
    cfg["training"]["max_epochs"] = 1
    cfg["training"]["pl_cfg"] = {"val_check_interval": 0.5}
    cfg["out_dir"] = out_dir
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    save_dir = os.path.join(out_dir, cfg["expname"])
    args = ["--config", cfg_path, "--synthetic_data"]
    res = {}

    # 1. --fast_dev_run
    t0 = time.perf_counter()
    state = entry.main(args + ["--fast_dev_run"])
    res["fast_dev_run_s"] = time.perf_counter() - t0
    check(int(state.step) == 1, "--fast_dev_run: not one step")
    for name in ("config.json", "metrics.jsonl"):
        check(os.path.isfile(os.path.join(save_dir, name)),
              f"--fast_dev_run wrote no {name}")

    # 2. one epoch of fit: validation's launches and the training dataset's
    # draws (kernel C, in the main thread: the loader loads inline at
    # train_num_workers 1) counted apart, so that what is left is the steps'
    val_calls, val_launch, val_s = [], {}, []
    data_launch, in_val = {}, [False]
    real_make_val_fn = eval_loop.make_val_fn

    def counted_make_val_fn(*a, **k):
        val_fn = real_make_val_fn(*a, **k)

        def wrapped(state, step, logger):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t = time.perf_counter()
            in_val[0] = True
            try:
                out = val_fn(state, step, logger)
            finally:
                in_val[0] = False
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t)
            for k_, v in ops.launch_counts().items():
                val_launch[k_] = val_launch.get(k_, 0) + v - before[k_]
            val_calls.append((int(step), out))
            return out
        return wrapped

    real_render_view = synthetic.render_view

    def counted_render_view(*a, **k):
        before = ops.launch_counts()
        out = real_render_view(*a, **k)
        if not in_val[0]:       # validation's draws are in val_launch
            for k_, v in ops.launch_counts().items():
                data_launch[k_] = data_launch.get(k_, 0) + v - before[k_]
        return out

    # each step inside fit timed on the card's clock between two events,
    # with no synchronization, so that the host runs ahead as it does
    # untimed: fit's ms/step less this is what the loop costs
    real_make_step = training.make_train_step
    step_events = []

    def timed_make_step(*a, **k):
        step_fn = real_make_step(*a, **k)

        def timed(*a2, **k2):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step_fn(*a2, **k2)
            ev[1].record()
            step_events.append(ev)
            return out
        return timed

    eval_loop.make_val_fn = counted_make_val_fn
    training.make_train_step = timed_make_step
    synthetic.render_view = counted_render_view
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        state = entry.main(args)
        torch.cuda.synchronize()
        res["fit_invocation_s"] = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        eval_loop.make_val_fn = real_make_val_fn
        training.make_train_step = real_make_step
        synthetic.render_view = real_render_view
    step_ms = [a.elapsed_time(b) for a, b in step_events]
    steps = int(state.step)
    check(steps == 8, f"one epoch took {steps} steps, not 8")
    check([s for s, _ in val_calls] == [4, 8],
          f"val_fn ran at steps {[s for s, _ in val_calls]}, not [4, 8]")
    for _, logs in val_calls:
        check(all(math.isfinite(v) for v in logs.values())
              and "val_total_loss" in logs, f"val logs {logs}")
    check(data_launch.get("rasterize", 0) > 0,
          "the synthetic training dataset did not rasterize on the card")
    train_launches = {k: v - val_launch.get(k, 0) - data_launch.get(k, 0)
                      for k, v in launches.items()}
    check_train_launches(train_launches, steps, 0, 0, False)
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epoch_s = [r for r in recs if "epoch_time_s" in r][-1]["epoch_time_s"]
    res.update(steps=steps, val_steps=[s for s, _ in val_calls],
               launches=launches, val_launches=val_launch,
               data_launches=data_launch,
               train_launches=train_launches, epoch_s=epoch_s,
               val_s=val_s, val_logs=[lg for _, lg in val_calls],
               fit_ms_per_step=(epoch_s - sum(val_s)) / steps * 1e3,
               step_ms_in_fit=step_ms,
               step_ms_in_fit_mean=sum(step_ms) / len(step_ms))
    saved = state_blob(state)

    # 3. a second invocation resumes: the state equal to the saved one
    t0 = time.perf_counter()
    resumed = entry.main(args)
    res["resume_invocation_s"] = time.perf_counter() - t0
    differ = tensors_equal(state_blob(resumed), saved)
    check(not differ, f"the resumed state differs from the saved one at "
          f"{differ[:5]}")
    res["resumed_step"] = int(resumed.step)

    # 4. --run_val --model_ckpt <the checkpoint directory>
    real_render = eval_loop.render_full_image
    render_s = []

    def timed_render(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_render(*a, **k)
        torch.cuda.synchronize()
        render_s.append(time.perf_counter() - t)
        return out

    eval_loop.render_full_image = timed_render
    real_run_test = eval_loop.run_test
    run_test_s = []

    def timed_run_test(*a, **k):
        t = time.perf_counter()
        out = real_run_test(*a, **k)
        run_test_s.append(time.perf_counter() - t)
        return out

    eval_loop.run_test = timed_run_test
    try:
        entry.main(args + ["--run_val", "--model_ckpt",
                           os.path.join(save_dir, "ckpts")])
    finally:
        eval_loop.render_full_image = real_render
        eval_loop.run_test = real_run_test
    yml = [n for n in os.listdir(save_dir) if n.endswith(".yml")]
    check(yml == ["test_test_1_8.yml"], f"reports {yml}")
    report = {}
    with open(os.path.join(save_dir, yml[0])) as f:
        for line in f:
            k, v = line.rstrip("\n").split(": ", 1)
            report[k] = v
    for k in ("psnr", "ssim", "mse"):
        check(math.isfinite(float(report[k])), f"report {k} = {report[k]}")
    check(report["lpips_pretrained"] == "false",
          f"lpips_pretrained: {report['lpips_pretrained']}")
    frames = len(render_s)
    check(frames == 16, f"run_test rendered {frames} frames, not 16")
    res.update(report=report, frames=frames,
               run_test_ms_per_frame=run_test_s[0] / frames * 1e3,
               render_ms_per_frame=sum(render_s) / frames * 1e3)
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 8: the free-viewpoint video, ``python -m
# vanerf_tpu_torch.render_dynamic``, in process
# ---------------------------------------------------------------------------

VIDEO_FRAMES = 20
# orbit camera 0's patch on the card against the CPU port's: 8x8 rays
# spread over the whole frame (16 + 32 i pixels), phase 4's tolerance
VIDEO_RAYS = 8


def face_distances(p, tri):
    """float64 distances from the point p (3,) to each triangle (F, 3, 3):
    the nearest of the corners, the edges' closest points and the plane's
    projection where it lies inside (``tests/oracles.py``, over all faces
    at once)."""
    import numpy as np
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    cands = [a, b, c]
    for u, v in ((a, b), (b, c), (c, a)):
        d = v - u
        t = np.clip(((p - u) * d).sum(1) / np.maximum((d * d).sum(1),
                                                       1e-30), 0.0, 1.0)
        cands.append(u + t[:, None] * d)
    n = np.cross(b - a, c - a)
    nn = np.maximum((n * n).sum(1), 1e-30)
    q = p - (((p - a) * n).sum(1) / nn)[:, None] * n
    v0, v1, v2 = b - a, c - a, q - a
    d00, d01, d11 = (v0 * v0).sum(1), (v0 * v1).sum(1), (v1 * v1).sum(1)
    d20, d21 = (v2 * v0).sum(1), (v2 * v1).sum(1)
    den = d00 * d11 - d01 * d01
    safe = np.where(np.abs(den) > 1e-30, den, 1.0)
    w1 = (d11 * d20 - d01 * d21) / safe
    w2 = (d00 * d21 - d01 * d20) / safe
    inside = (np.abs(den) > 1e-30) & (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
    dist = np.min([np.linalg.norm(p - x, axis=1) for x in cands], 0)
    return np.where(inside, np.minimum(dist, np.linalg.norm(p - q, axis=1)),
                    dist)


def certify_ties(verts, faces, vert_vis, points):
    """(n,) bool: each point's nearest faces tie, and their visibilities,
    interpolated at the point's projection on each face's plane (the
    query's rule), fall on both sides of the 0.1 threshold: either face is
    a right answer.  Faces tie when their float64 squared distances lie
    within 4 float32 units of the squared magnitudes a float32 query rounds
    at (the point's and the farthest vertex's, uncentred), where no float32
    query can tell them apart."""
    import numpy as np
    V = np.asarray(verts, np.float64)
    F = np.asarray(faces)
    vis = np.asarray(vert_vis, np.float64)[:, 0]
    tri = V[F]
    r2 = (V * V).sum(1).max()
    ok = []
    for p in np.asarray(points, np.float64):
        d2 = face_distances(p, tri) ** 2
        tol = 4 * np.finfo(np.float32).eps * (p @ p + r2)
        tied = np.nonzero(d2 <= d2.min() + tol)[0]
        a, b, c = (tri[tied, i] for i in range(3))
        u, v, w = b - a, c - a, p - a
        n = np.cross(u, v)
        nn = (n * n).sum(1)
        b2 = (np.cross(u, w) * n).sum(1) / nn
        b1 = (np.cross(w, v) * n).sum(1) / nn
        qv = ((1 - b1 - b2) * vis[F[tied, 0]] + b1 * vis[F[tied, 1]]
              + b2 * vis[F[tied, 2]])
        ok.append(len(set((qv >= 0.1).tolist())) == 2)
    return np.array(ok, bool)


def gif_image_blocks(data: bytes) -> int:
    """The number of image descriptors of a GIF89a, walking its blocks."""
    check(data[:6] == b"GIF89a", "nvs.gif: not a GIF89a")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    images = 0

    def skip_sub_blocks(i):
        while data[i]:
            i += data[i] + 1
        return i + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:                         # extension
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:                       # image
            images += 1
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)            # LZW code size, data
        else:
            check(False, f"nvs.gif: block 0x{data[pos]:02x} at {pos}")
    return images


def mp4_samples(data: bytes) -> list:
    """The samples of a one-track mp4 (``stsz`` sizes at ``stco``
    offsets), its boxes walked with ``video.parse_boxes``."""
    import struct
    from vanerf_tpu_torch.video import parse_boxes

    def child(start, end, kind):
        got = [(s, e) for t, s, e in parse_boxes(data, start, end)
               if t == kind]
        check(len(got) == 1, f"nvs.mp4: {len(got)} {kind} boxes")
        return got[0]

    span = (0, len(data))
    for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        span = child(*span, kind)
    s, _ = child(*span, b"stsz")
    n, = struct.unpack(">I", data[s + 8:s + 12])
    sizes = struct.unpack(f">{n}I", data[s + 12:s + 12 + 4 * n])
    s, _ = child(*span, b"stco")
    check(struct.unpack(">I", data[s + 4:s + 8])[0] == n,
          "nvs.mp4: stco and stsz count different samples")
    offs = struct.unpack(f">{n}I", data[s + 8:s + 8 + 4 * n])
    return [data[o:o + z] for o, z in zip(offs, sizes)]


def patch_card_vs_cpu_ties(model, b_card, grids, n_views: int = 1,
                           tag: str = "patch", cached_cpu=None) -> dict:
    """An 8x8-ray patch on the card and on the CPU port (its own encode,
    or ``cached_cpu``, an encode of the same frame by CPU encoders equal to
    the model's), phase 4's tolerance on tex_fg, alpha and their fine
    forms.  The CPU
    query takes the card's visibility decision on each sample where the two
    differ and :func:`certify_ties` certifies a tie (any other difference
    fails): such a tie falls by rounding, and the texture fusion's
    global-context pool would spread it over the patch."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    model_cpu = copy.deepcopy(model).cpu()
    b_cpu = {k: v.cpu() if torch.is_tensor(v) else v
             for k, v in b_card.items()}
    if cached_cpu is None:
        cached_cpu = tr.encode_frame(model_cpu, b_cpu, n_views=n_views)
    kw = dict(out_h=VIDEO_RAYS, out_w=VIDEO_RAYS, sample_per_ray_c=S_C,
              sample_per_ray_f=S_F, compute_vis_map=False, n_views=n_views)
    real_query = tr.cal_vis_sdf_prepared
    card_vis, log = [], {"differ": 0, "uncertified": 0}

    def record(mesh, points, *a, **k):
        out = real_query(mesh, points, *a, **k)
        card_vis.append(out[1].cpu())
        return out

    verts = b_cpu["verts"][0].numpy()
    faces = b_cpu["faces"].numpy()
    vis = cached_cpu[2][0].numpy()
    card_it = iter(card_vis)

    def take_ties(mesh, points, *a, **k):
        sdf, qvis, far = real_query(mesh, points, *a, **k)
        want = next(card_it)
        differ = (want != qvis)[0, :, 0].nonzero().flatten()
        ok = torch.from_numpy(certify_ties(verts, faces, vis,
                                           points[0, differ].numpy()))
        qvis = qvis.clone()
        qvis[0, differ[ok]] = want[0, differ[ok]]
        log["differ"] += len(differ)
        log["uncertified"] += int((~ok).sum())
        return sdf, qvis, far

    try:
        tr.cal_vis_sdf_prepared = record
        got = tr.render_patch(model, b_card, grids=grids.to(b_card["verts"]
                                                             .device), **kw)
        torch.cuda.synchronize()
        tr.cal_vis_sdf_prepared = take_ties
        want = tr.render_patch(model_cpu, b_cpu, grids=grids,
                               cached=cached_cpu, **kw)
    finally:
        tr.cal_vis_sdf_prepared = real_query
    check(log["uncertified"] == 0, f"{tag}: {log['uncertified']} "
          "visibility decisions differ between card and CPU off a tie")
    check(torch.equal(tr.encode_frame(model, b_card,
                                      n_views=n_views)[2].cpu(),
                      cached_cpu[2]),
          f"{tag}: the card's vertex visibility differs from the CPU's")
    errs = {}
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        a, c = got[k].cpu(), want[k]
        errs[k] = (a - c).abs().max().item()
        check(torch.allclose(a, c, rtol=TIER_CPU_RTOL, atol=TIER_CPU_ATOL),
              f"{tag}: card vs CPU mismatch in {k}: {errs[k]}")
    check(want["alpha_fine"].max().item() > 0.5,
          f"{tag} missed: alpha_fine max {want['alpha_fine'].max().item()}")
    return {"max_abs_err": errs, "ties": log,
            "alpha_fine_max": want["alpha_fine"].max().item()}


def video_patch_card_vs_cpu(res) -> dict:
    """Orbit camera 0's 8x8-ray patch, its rays spread over the whole frame
    (16 + 32 i pixels), on the card against the CPU port's
    (:func:`patch_card_vs_cpu_ties`)."""
    import torch
    from vanerf_tpu_torch import render_dynamic as rd
    b_card = rd.camera_batch(res["batch"], res["cams"][0])
    r = torch.arange(VIDEO_RAYS, dtype=torch.float32) * (W // VIDEO_RAYS) \
        + W // (2 * VIDEO_RAYS)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    grids = torch.stack([gx, gy], -1).reshape(1, -1, 2)
    return patch_card_vs_cpu_ties(res["model"], b_card, grids,
                                  tag="orbit patch")


def phase_video(model, dev) -> dict:
    """``vanerf_tpu_torch.render_dynamic.main`` at full width
    (``configs/vanerf.json``, the 256^2 subdiv-3 fixture, 20 orbit frames)
    into ``build/video`` (removed after), on the seeded model of the other
    phases: the frames' times, launches and foreground; the PNGs read back,
    the mp4's samples and the GIF's image blocks; orbit camera 0 rendered
    again equal to its frame; one profiled frame; the PNG, JPEG and GIF
    encoders' host time a frame; camera 0's patch on the card against the
    CPU port's."""
    import shutil
    import statistics
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import render_dynamic as rd
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import synthetic
    from vanerf_tpu_torch.evaluator import read_png, write_png
    from vanerf_tpu_torch.image_codecs import encode_gif, encode_jpeg
    out_dir = os.path.join(REPO, "build", "video")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg = default_cfg()
    cfg["dataset"]["synthetic_cfg"] = {"H": H, "W": W, "subdiv": SUBDIV}
    cfg["video_cfg"] = {"n_frames": VIDEO_FRAMES}
    cfg["out_dir"] = out_dir
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    # each frame timed on the host clock between two synchronizations; its
    # float output kept; the source view's raster (kernel C) counted apart
    frame_ms, outs, data_launch = [], [], {}
    real_render, real_view = rd.renderer.render_full_image, \
        synthetic.render_view

    def timed_render(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_render(*a, **k)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        outs.append({k_: out[k_] for k_ in ("tex_fg_fine", "alpha_fine")})
        return out

    def counted_view(*a, **k):
        before = ops.launch_counts()
        out = real_view(*a, **k)
        for k_, v in ops.launch_counts().items():
            data_launch[k_] = data_launch.get(k_, 0) + v - before[k_]
        return out

    rd.renderer.render_full_image = timed_render
    synthetic.render_view = counted_view
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = rd.main(["--config", cfg_path, "--synthetic_data"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        rd.renderer.render_full_image = real_render
        synthetic.render_view = real_view
    check(len(res["frames"]) == VIDEO_FRAMES == len(frame_ms),
          f"{len(res['frames'])} frames, not {VIDEO_FRAMES}")
    differ = tensors_equal(res["model"].state_dict(), model.state_dict())
    check(not differ, f"render_dynamic's model is not the seeded model of "
          f"the other phases: {differ[:5]}")
    frame_launches = {k: (v - data_launch.get(k, 0)) / VIDEO_FRAMES
                      for k, v in launches.items()}
    for name in ("mesh_query", "knn", "rasterize", "interp_mxu",
                 "row_gather"):
        check(launches[name] - data_launch.get(name, 0) > 0,
              f"the video path launched no {name}")
    alpha_max = [o["alpha_fine"].max().item() for o in outs]
    check(max(alpha_max) > 0.5, f"no orbit frame sees the hands: alpha "
          f"{alpha_max}")
    for o in outs:
        check(torch.isfinite(o["tex_fg_fine"]).all().item(),
              "non-finite frame")

    # the files: 20 PNGs equal to the frames, the mp4's 20 JPEG samples, the
    # GIF's 20 image blocks
    vdir = res["out_dir"]
    names = sorted(os.listdir(vdir))
    check(names == [f"{i:06d}.png" for i in range(VIDEO_FRAMES)]
          + ["nvs.gif", "nvs.mp4"], f"video files {names}")
    for i, frame in enumerate(res["frames"]):
        check(bool((read_png(os.path.join(vdir, f"{i:06d}.png"))
                    == frame).all()), f"{i:06d}.png differs from its frame")
    with open(os.path.join(vdir, "nvs.mp4"), "rb") as f:
        samples = mp4_samples(f.read())
    check(len(samples) == VIDEO_FRAMES
          and all(x[:2] == b"\xff\xd8" and x[-2:] == b"\xff\xd9"
                  for x in samples), "nvs.mp4: not 20 JPEG samples")
    with open(os.path.join(vdir, "nvs.gif"), "rb") as f:
        gif = f.read()
    check(gif_image_blocks(gif) == VIDEO_FRAMES, "nvs.gif: not 20 images")

    # orbit camera 0 again, directly: equal to its frame to the bit
    b0 = rd.camera_batch(res["batch"], res["cams"][0])

    def frame0():
        return real_render(res["model"], b0, level=res["level"],
                           tile_group=res["tile_group"])

    again = frame0()
    check(torch.equal(again["tex_fg_fine"], outs[0]["tex_fg_fine"]),
          "orbit camera 0 rendered again differs from its frame")
    check(bool((rd.to_uint8(again["tex_fg_fine"]) == res["frames"][0])
               .all()), "orbit camera 0's uint8 frame differs")
    prof = bench.device_profile(frame0, dev)

    # the encoders' host time a frame
    def host_ms(fn):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3 / VIDEO_FRAMES

    png_path = os.path.join(out_dir, "again.png")
    enc = {"png_ms": host_ms(lambda: [write_png(png_path, f)
                                      for f in res["frames"]]),
           "jpeg_ms": host_ms(lambda: [encode_jpeg(f)
                                       for f in res["frames"]]),
           "gif_ms": host_ms(lambda: encode_gif(res["frames"]))}
    patch = video_patch_card_vs_cpu(res)
    shutil.rmtree(out_dir, ignore_errors=True)
    return dict(frame_ms=frame_ms, first_ms=frame_ms[0],
                rest_median_ms=statistics.median(frame_ms[1:]),
                main_s=main_s, peak_bytes=peak, launches=launches,
                data_launches=data_launch, frame_launches=frame_launches,
                alpha_max=alpha_max, level=res["level"],
                tile_group=res["tile_group"], frame0_profile=prof,
                encoders=enc, mp4_bytes=sum(len(x) for x in samples),
                gif_bytes=len(gif), patch=patch)


# ---------------------------------------------------------------------------
# phase 9: two source views (dataset.num_input_view = 2)
# ---------------------------------------------------------------------------

VIEWS = 2
# the two-view frame's tile groups, each frame in turns with the one-view
# frame at the same G
VIEW_TILE_GROUPS = (1, 16)
VIEW_ROUNDS = 2
VIEW_TRAIN_STEPS = 3


def views_frame(dev):
    """The 256^2 subdiv-3 fixture's first frame with two source views, its
    images and cameras flattened to (V, ...): (numpy batch, torch batch)."""
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    batch_np, _faces, _num_v = make_synthetic_batch(
        batch_size=1, H=H, W=W, subdiv=SUBDIV, num_input_view=VIEWS,
        device=dev)
    return batch_np, to_torch(batch_np, dev)


def views_kernel_inputs(model, b2, G: int):
    """The coarse pass of the first G-tile group of the two-view frame at
    level 3, repeated per view as the query repeats it (element e view v at
    e V + v): the coarse geometry maps (V, 32, 32, 64), each element-view's
    (u, v) on its view's map (G V, N, 2) and the nearest-vertex ids
    repeated per view (G V, N)."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.models.vanerf import per_element
    from vanerf_tpu_torch.ops import knn
    s = 4
    offsets = [(j, i) for i in range(s) for j in range(s)][:G]
    dev = b2["src_img"].device
    grids = tr.strided_grid(G, H, W, 3, torch.tensor(offsets,
                                                      dtype=torch.float32),
                            device=dev)
    eb = dict(b2, **{k: per_element(b2[k], G)
                     for k in ("tar_k", "tar_rt", "bounds")})
    cam_pos, cam_rays, z = tr.patch_rays(eb, grids, S_C)
    pts = (cam_pos[:, :, None] + cam_rays[:, :, None] * z[..., None]) \
        .reshape(G, -1, 3).contiguous()
    idx = knn.nearest_vertex_d2(pts, b2["verts"].contiguous())[0]
    feat_geo, _ft, _vv = tr.encode_frame(model, b2, n_views=VIEWS)
    v = pts.repeat_interleave(VIEWS, 0)
    krt = per_element(b2["src_krt"], G * VIEWS)
    vh = v @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
    xy = vh[..., :2] / vh[..., 2:3]
    uv = torch.stack([2.0 * xy[..., 0] / (W - 1.0) - 1.0,
                      2.0 * xy[..., 1] / (H - 1.0) - 1.0], -1).contiguous()
    return (feat_geo[0].contiguous(), uv,
            idx.repeat_interleave(VIEWS, 0).contiguous())


def views_kernels(model, b2, dev) -> dict:
    """Phase 9a: kernels D and 10 over the two-view batch of one frame
    (G = 1: 2 element-views on 2 maps / tables) and of a 16-tile group (32
    element-views), one launch each, every element-view equal to the bit to
    its own launch and the whole to the plain version; at G = 16 the
    batched launch's device time (a CUDA graph) beside element-view 0's and
    the batched launch's bound.  Then kernel 13 at the two-view training
    shapes, each view's 262,144 rows into its KNN table (1,284 x 204), its
    32^2 coarse map (1,024 x 256) and its 64^2 map (4,096 x 32), against
    its plain version to 1e-5 of the row's sum of |g|."""
    import torch
    from vanerf_tpu_torch.ops import interp_mxu, onehot_gather
    res = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n_verts = b2["verts"].shape[1]
    for G in (1, 16):
        geo, uv, idx = views_kernel_inputs(model, b2, G)
        E = uv.shape[0]
        table = torch.randn(VIEWS, n_verts, 204, generator=gen, device=dev)
        r = res[f"g{G}"] = {"element_views": E, "maps": VIEWS}
        for name, fn, plain, args in (
                ("interp_mxu", interp_mxu.interp_cuda,
                 interp_mxu.interp_plain, (geo, uv)),
                ("row_gather", interp_mxu.row_gather_cuda,
                 interp_mxu.row_gather_plain, (table, idx))):
            got = fn(*args)
            check(torch.equal(got, plain(*args)), f"phase 9a {name}: the "
                  f"{E} element-views differ from the plain version")
            for e in range(E):
                check(torch.equal(got[e], fn(args[0][e % VIEWS],
                                             args[1][e])),
                      f"phase 9a {name}: element-view {e} of {E} differs "
                      "from its own launch")
            if G == 1:
                continue
            if name == "interp_mxu":
                bound = least_time(nbytes(geo, uv, got),
                                   E * uv.shape[1] * (20 + 7 * geo.shape[-1]))
            else:
                bound = least_time(nbytes(table, idx, got), 0)
            r[name] = dict(
                batch_device_ms=graph_ms(lambda: fn(*args),
                                         3 if name == "row_gather" else 10),
                element_device_ms=graph_ms(lambda: fn(args[0][0],
                                                      args[1][0])),
                batch_bound_ms=bound["bound_ms"],
                batch_bound_by=bound["bound_by"])
        if G == 1:
            cases = []
            for v in range(VIEWS):
                cases += [(f"view {v} knn table", idx[v], n_verts, 204),
                          (f"view {v} 32^2 coarse map",
                           texel(uv[v], geo.shape[1]), geo.shape[1] ** 2,
                           4 * geo.shape[-1]),
                          (f"view {v} 64^2 map", texel(uv[v], 64), 64 * 64,
                           4 * 8)]
            worst = 0.0
            for tag, rows, T_, C in cases:
                g = torch.randn(rows.shape[0], C, generator=gen, device=dev)
                rows = rows.contiguous()
                got = onehot_gather.onehot_scatter_cuda(g, rows, T_)
                want = onehot_gather.onehot_scatter_plain(g, rows, T_)
                bound = onehot_gather.onehot_scatter_plain(g.abs(), rows, T_)
                e = (got - want).abs()
                check(bool((e <= 1e-5 * bound + 1e-30).all()),
                      f"phase 9a scatter err {e.max().item()} ({tag})")
                worst = max(worst,
                            (e / bound.clamp(min=1e-30)).max().item())
            res["onehot_scatter"] = dict(cases=[c[0] for c in cases],
                                         rel_to_abs_sum=worst)
    torch.cuda.synchronize()
    return res


def views_frames(model, b1, b2, dev) -> dict:
    """Phase 9b: the 256^2 two-view frame at full width at each G of
    VIEW_TILE_GROUPS: the first frame's ms, peak memory and launches (2 s^2
    / G = 32 / G of each of B, A, D and 10: the points are the frame's, D
    and 10 take every view of a pass in one launch; 1 of C, the first
    view's vertex visibility), then VIEW_ROUNDS rounds in turns with the
    one-view frame at the same G, device ops and busy time of one more
    frame under torch.profiler; the G = 16 frame held to the G = 1 frame as
    phase 3i holds it."""
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import renderer as tr
    runs = {G: dict(frame_ms=[], one_view_ms=[]) for G in VIEW_TILE_GROUPS}
    outs = {}

    def frame(G, n_views):
        return tr.render_full_image(
            model, b2 if n_views > 1 else b1, level=3, sample_per_ray_c=S_C,
            sample_per_ray_f=S_F, n_views=n_views, tile_group=G)

    for G in VIEW_TILE_GROUPS:
        r = runs[G]
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs[G] = frame(G, VIEWS)
        torch.cuda.synchronize()
        r.update(first_ms=(time.perf_counter() - t0) * 1e3,
                 peak_bytes=torch.cuda.max_memory_allocated(dev),
                 launches=ops.launch_counts())
        want = {"knn": 32 // G, "mesh_query": 32 // G,
                "interp_mxu": 32 // G, "row_gather": 32 // G,
                "rasterize": 1, "onehot_scatter": 0}
        for name, n in want.items():
            got = r["launches"][name]
            check(got == n, f"two views, tile_group={G}: {got} launches of "
                  f"{name} a frame, not {n}")
    for _ in range(VIEW_ROUNDS):
        for G in VIEW_TILE_GROUPS:
            runs[G]["frame_ms"].append(bench.timed(lambda: frame(G, VIEWS),
                                                   dev))
            runs[G]["one_view_ms"].append(bench.timed(lambda: frame(G, 1),
                                                      dev))
    for G in VIEW_TILE_GROUPS:
        runs[G].update(bench.device_profile(lambda: frame(G, VIEWS), dev))
    for G in VIEW_TILE_GROUPS[1:]:
        worst, share, abs_err = hold_to_fused_bounds(
            f"two views, tile_group={G}", [outs[G]], [outs[1]])
        runs[G].update(of_bound=worst, share_outside=share,
                       max_abs_err=abs_err)
    check(outs[1]["alpha_fine"].max().item() > 0.2,
          "two-view frame: rays missed the hands")
    grids = tr.mask_centered_grid(torch.Generator().manual_seed(SEED + 4),
                                  b2["tar_mask"][..., 0].cpu(), VIDEO_RAYS,
                                  VIDEO_RAYS)
    return dict(frames=runs, patch=patch_card_vs_cpu_ties(
        model, b2, grids, n_views=VIEWS, tag="two-view patch"))


def views_train(model, b2, cfg, dev) -> dict:
    """Phase 9c: VIEW_TRAIN_STEPS faithful GAN steps at two views and full
    width from the seeded weights and draws (the view dropout drawn from
    the step's generator): ms/step, peak, launches (as phase 5 holds them),
    every loss and parameter finite, and the IBR head's gradient (``mlp_tex``,
    skipped at one view) non-zero in every step; then two steps from one
    state and one seed of draws, equal to the bit (as phase 5f)."""
    trainer = Trainer(model, b2, cfg, dev, n_views=VIEWS)
    names = [n for n, _ in trainer.gen_model.named_parameters()]
    real, ibr = trainer.state.opt_g.step, []

    def step(grads):
        ibr.append(math.sqrt(sum(
            float(g.float().pow(2).sum()) for n, g in zip(names, grads)
            if n.startswith("mlp_tex.") and g is not None)))
        real(grads)

    trainer.state.opt_g.step = step
    for _ in range(VIEW_TRAIN_STEPS):
        trainer.step()
    res = trainer.result()
    check_train_launches(res["launches"], VIEW_TRAIN_STEPS, 0, 0, False)
    check(len(ibr) == VIEW_TRAIN_STEPS and min(ibr) > 0,
          f"two views: the IBR head's gradient norms {ibr}")
    rep = repeat_step(model, b2, cfg, dev, n_views=VIEWS)
    check(rep["bit_equal"], f"two-view train step does not repeat to the "
          f"bit: logs {rep['logs_differ']}, {len(rep['params_differ'])} "
          f"parameters, first output {rep['first_output_differing']}")
    res.update(mlp_tex_grad_norm=ibr, repeat=rep)
    return res


def views_entry_point() -> dict:
    """Phase 9d: ``vanerf_tpu_torch.train.main`` on the card (no
    ``--device``) with a two-view config written under ``build/``
    (``dataset.num_input_view: 2``; the 256^2 subdiv-3 fixture, one frame
    x 2 cameras: 2 steps an epoch, ``val_fn`` on one frame after the
    second): one epoch of ``fit``, then ``--run_val --model_ckpt`` on its
    checkpoint (4 test frames); every query at two views, the launches of
    A, B, C, D, 10 and 13 over both invocations, the validation loss and
    the report's psnr / ssim / mse finite."""
    import shutil
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import train as entry
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF
    out_dir = os.path.join(REPO, "build", "views_entry")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg = default_cfg()
    cfg["dataset"]["num_input_view"] = VIEWS
    cfg["dataset"]["synthetic_cfg"] = {"H": H, "W": W, "subdiv": SUBDIV,
                                       "n_frames": 1, "n_cams": 2}
    cfg["dataset"].setdefault("val_cfg", {})["max_len"] = 1
    cfg["training"]["max_epochs"] = 1
    cfg["training"]["pl_cfg"] = {"val_check_interval": 1.0}
    cfg["out_dir"] = out_dir
    cfg_path = os.path.join(out_dir, "two_views.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    save_dir = os.path.join(out_dir, cfg["expname"])
    args = ["--config", cfg_path, "--synthetic_data"]
    seen, real = set(), VANeRF.query

    def spy(self, *a, **k):
        seen.add(a[13] if len(a) > 13 else k.get("n_views", 1))
        return real(self, *a, **k)

    VANeRF.query = spy
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        state = entry.main(args)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        entry.main(args + ["--run_val", "--model_ckpt",
                           os.path.join(save_dir, "ckpts")])
        run_val_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        VANeRF.query = real
    check(int(state.step) == 2, f"two-view fit: {int(state.step)} steps")
    check(seen == {VIEWS}, f"two-view entry point: queries at {seen} views")
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        val = [r["val_total_loss"] for r in map(json.loads, f)
               if "val_total_loss" in r]
    check(bool(val) and all(math.isfinite(v) for v in val),
          f"two-view val_total_loss {val}")
    names = [n for n in os.listdir(save_dir) if n.endswith(".yml")]
    check(len(names) == 1, f"two-view run_test reports {names}")
    with open(os.path.join(save_dir, names[0])) as f:
        report = dict(line.strip().split(": ", 1) for line in f)
    for k in ("psnr", "ssim", "mse"):
        check(math.isfinite(float(report[k])), f"two-view report {k} "
              f"{report[k]}")
    for name in ("mesh_query", "knn", "rasterize", "interp_mxu",
                 "row_gather", "onehot_scatter"):
        check(launches[name] > 0, f"the two-view entry point launched no "
              f"{name}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return dict(fit_s=fit_s, run_val_s=run_val_s, launches=launches,
                val_total_loss=val, report=report)


def maps_forward(model, maps) -> None:
    """Make ``model.encode`` return the values ``maps`` = ([coarse, fine]
    geometry maps, texture map), their gradients reaching the model's own
    encoder (as phase 3h renders both devices' patches from one encode)."""
    import torch

    class Values(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, want):
            return want.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None

    real = type(model).encode.__get__(model)
    fg_w, ft_w = maps

    def encode(im):
        fg, ft = real(im)
        return ([Values.apply(a, w.to(a.device)) for a, w in zip(fg, fg_w)],
                Values.apply(ft, ft_w.to(ft.device)))
    model.encode = encode


def train_grad_setup(batch_np, cfg):
    """Phase 6's 16x16-ray training config and its draws (CPU tensors)."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    cfg = copy.deepcopy(cfg)
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 16
    P = 16 * 16
    gen = torch.Generator().manual_seed(SEED + 4)
    b_cpu = to_torch(batch_np, "cpu")
    draws = {"grids": tr.mask_centered_grid(gen, b_cpu["tar_mask"][..., 0],
                                            16, 16),
             "u_c": torch.rand(1, P, S_C, generator=gen),
             "noise_c": torch.randn(1, P * S_C, 1, generator=gen),
             "u_f": torch.rand(1, P, S_F, generator=gen),
             "noise_f": torch.randn(1, P * S_F, 1, generator=gen)}
    return cfg, draws


def g_loss_grads(model, batch_np, cfg, draws, where, maps=None):
    """The G loss of one training patch on ``where`` and every generator
    gradient (on the CPU); ``maps``: the map values to take (maps_forward)."""
    import torch
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.training import generator_loss, generator_outputs
    g_model, disc, vgg = train_parts(model, where)
    if maps is not None:
        maps_forward(g_model, maps)
    out = generator_outputs(g_model, to_torch(batch_np, where), cfg,
                            draws=draws)
    loss, _ = generator_loss(out, disc, vgg, cfg)
    grads = torch.autograd.grad(loss, list(g_model.parameters()),
                                allow_unused=True)
    names = [n for n, _ in g_model.named_parameters()]
    return loss.item(), {
        n: (torch.zeros_like(p) if gr is None else gr).detach().float().cpu()
        for n, p, gr in zip(names, g_model.parameters(), grads)}


def phase_train_card_vs_cpu(model, batch_np, cfg, dev, loose=(),
                            cpu_model=None):
    """Phase 6: the G loss of one 16x16-ray training patch and every
    generator gradient on the card against the CPU port (of ``cpu_model``
    where given), each gradient within CARD_CPU_GRAD_RTOL of its norm plus
    CARD_CPU_GRAD_ATOL of the whole, those under a prefix in ``loose``
    within SP_LOOSE_RTOL of theirs instead (phase 11e)."""
    import torch
    cfg, draws = train_grad_setup(batch_np, cfg)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = (
        g_loss_grads(net, batch_np, cfg, draws, where)
        for net, where in ((model, dev), (cpu_model or model,
                                          torch.device("cpu"))))
    total = sum(float(g.double().pow(2).sum()) for g in g_cpu.values()) ** .5
    rows = []
    for n, gc in g_cpu.items():
        nc = float(gc.double().norm())
        e = float((g_gpu[n].double() - gc.double()).norm())
        rtol = (SP_LOOSE_RTOL if loose and n.startswith(loose)
                else CARD_CPU_GRAD_RTOL)
        allowed = rtol * nc + CARD_CPU_GRAD_ATOL * total
        rows.append((e / allowed, e / nc if nc > 0 else 0.0, nc / total, n))
    rows.sort(reverse=True)
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    check(loss_err <= CARD_CPU_LOSS_RTOL, f"G loss card {l_gpu} cpu {l_cpu}")
    check(rows[0][0] <= 1.0, f"gradient of {rows[0][3]}: error "
          f"{rows[0][0]:.3g} x its bound")
    rel = max(rows, key=lambda r: r[1])
    tight = max((r for r in rows if not (loose and r[3].startswith(loose))),
                key=lambda r: r[1])
    return dict(loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_err=loss_err,
                worst_tight_rel_err=tight[1], worst_tight_grad=tight[3],
                worst_of_bound=rows[0][0], worst_grad=rows[0][3],
                worst_grad_rel_err=rel[1], worst_rel_grad=rel[3],
                grad_norm=total,
                top5=[dict(name=r[3], of_bound=r[0], rel_err=r[1],
                           norm_share=r[2]) for r in rows[:5]]), g_cpu


def phase_train_card_vs_cpu_bf16(model, model16, batch_np, cfg, dev,
                                 g_cpu32):
    """Phase 6 in bfloat16: the same G-loss gradient of the bfloat16 model
    on the card and on the CPU, both from the CPU's encode (its map values,
    the gradients reaching each device's encoder).  Per tensor holding at
    least 1e-3 of the gradients' norm, the RMS error against the CPU's
    bfloat16 gradient at most S / 2 + 2 E (S the RMS of the CPU port's
    bfloat16-vs-float32 spread, E of the card's float32 gradient, from the
    same maps, against the CPU's: ``BF16_GRAD_SHARE``); the card's float32
    gradients taken together must fail that bound."""
    import torch
    from vanerf_tpu_torch.data import to_torch
    cfg, draws = train_grad_setup(batch_np, cfg)
    cpu = torch.device("cpu")
    with torch.no_grad():
        fg, ft = copy.deepcopy(model).cpu().encode(
            to_torch(batch_np, cpu)["src_img"])
    maps = ([f.clone() for f in fg], ft.clone())
    l16_cpu, g16_cpu = g_loss_grads(model16, batch_np, cfg, draws, cpu)
    l16, g16 = g_loss_grads(model16, batch_np, cfg, draws, dev, maps)
    l32, g32 = g_loss_grads(model, batch_np, cfg, draws, dev, maps)

    def rms(x):
        return float(x.double().pow(2).mean().sqrt())

    total = sum(float(g.double().pow(2).sum())
                for g in g_cpu32.values()) ** .5
    rows, ctrl_parts = [], []
    for n, c32 in g_cpu32.items():
        if float(c32.double().norm()) < BF16_GRAD_SHARE * total:
            continue
        S, E = rms(g16_cpu[n] - c32), rms(g32[n] - c32)
        err, bound = rms(g16[n] - g16_cpu[n]), S / 2 + 2 * E
        rows.append((err / bound if bound > 0 else float("inf"), n,
                     err / S if S > 0 else float("inf"),
                     float(c32.double().norm()) / total))
        ctrl_parts.append((g32[n].reshape(-1), g16_cpu[n].reshape(-1),
                           c32.reshape(-1)))
    rows.sort(reverse=True)
    check(rows and rows[0][0] <= 1.0, f"bfloat16 gradient of {rows[0][1]}: "
          f"RMS error {rows[0][0]:.3g} x S / 2 + 2 E")
    c_g32, c_16, c_32 = (torch.cat(p) for p in zip(*ctrl_parts))
    S, E = rms(c_16 - c_32), rms(c_g32 - c_32)
    ctrl = rms(c_g32 - c_16) / (S / 2 + 2 * E)
    check(ctrl > 1.0, f"the card's float32 gradients pass the bfloat16 bound "
          f"({ctrl:.3g} x)")
    return dict(loss_card=l16, loss_cpu=l16_cpu,
                loss_rel_err=abs(l16 - l16_cpu) / abs(l16_cpu),
                loss_f32_card=l32, tensors=len(rows),
                worst_of_bound=rows[0][0], worst_grad=rows[0][1],
                worst_of_S=rows[0][2], control_of_bound=ctrl,
                top5=[dict(name=r[1], of_bound=r[0], of_S=r[2],
                           norm_share=r[3]) for r in rows[:5]])


def run_phase_views(model, b1, cfg, dev) -> dict:
    """Phase 9 (two source views): 9a's kernels, 9b's frames and patch, 9c's
    training, 9d's entry point, each reported on its own lines."""
    import torch
    t0 = time.perf_counter()
    _b2_np, b2 = views_frame(dev)
    with torch.no_grad():
        vk = views_kernels(model, b2, dev)
        vf = views_frames(model, b1, b2, dev)
    cfg2 = copy.deepcopy(cfg)
    cfg2["dataset"]["num_input_view"] = VIEWS
    vt = views_train(model, b2, cfg2, dev)
    ve = views_entry_point()
    g16 = vk["g16"]
    say(f"phase 9a two views, kernels D and 10 over the element-views (one "
        f"frame: {vk['g1']['element_views']}, a 16-tile group: "
        f"{g16['element_views']}, on {VIEWS} maps / tables): one launch "
        f"each, equal to the bit to each element-view's own launch and to "
        f"the plain version; at the 16-tile group "
        + "; ".join(f"{n} {r['batch_device_ms']:.4f} ms device for the batch, "
                    f"{r['element_device_ms']:.4f} for element-view 0 alone "
                    f"(x {g16['element_views']} = "
                    f"{r['element_device_ms'] * g16['element_views']:.4f}), "
                    f"bound {r['batch_bound_ms']:.4f} by {r['batch_bound_by']}"
                    for n, r in ((n, g16[n])
                                 for n in ("interp_mxu", "row_gather")))
        + f"; kernel 13 at the two-view training shapes "
        f"({len(vk['onehot_scatter']['cases'])} tables) within "
        f"{vk['onehot_scatter']['rel_to_abs_sum']:.2g} of the row's sum of "
        f"|g| (bound 1e-5)")
    for G, r in vf["frames"].items():
        say(f"phase 9b two views, tile_group={G}: full image "
            f"{r['first_ms']:.1f} ms first, "
            f"{' / '.join(f'{t:.1f}' for t in r['frame_ms'])} ms in turns "
            f"with the one-view frame's "
            f"{' / '.join(f'{t:.1f}' for t in r['one_view_ms'])}; peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['device_ops']} device "
            f"ops, busy {r['device_busy_ms']:.1f} ms (torch.profiler); "
            f"launches A {r['launches']['mesh_query']}, B "
            f"{r['launches']['knn']}, C {r['launches']['rasterize']}, D "
            f"{r['launches']['interp_mxu']}, 10 {r['launches']['row_gather']}"
            f", 13 {r['launches']['onehot_scatter']}"
            + (f"; against G = 1: coarse outputs at most "
               f"{max(r['of_bound'][k] for k in COARSE_KEYS):.3g} of rtol "
               f"{FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it on "
               f"{max(r['share_outside'].values()):.3%} of their elements, "
               f"largest difference {max(r['max_abs_err'].values()):.3g}"
               if "of_bound" in r else ""))
    p = vf["patch"]
    say(f"phase 9b two-view {VIDEO_RAYS}x{VIDEO_RAYS}-ray patch card vs CPU: "
        f"{ {k: f'{v:.2g}' for k, v in p['max_abs_err'].items()} } (rtol "
        f"{TIER_CPU_RTOL} atol {TIER_CPU_ATOL}; {p['ties']['differ']} "
        f"certified visibility ties taken from the card)")
    say(f"phase 9c two-view training ({VIEW_TRAIN_STEPS} faithful GAN steps, "
        f"64x64 rays, 64+64 samples): {vt['ms_per_step']:.1f} ms/step (steps "
        f"2-{VIEW_TRAIN_STEPS}; all: {[round(t, 1) for t in vt['step_ms']]}); "
        f"peak {vt['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in vt['launches'].items() if v} }; g_loss "
        f"{[round(lg['train/g_loss'], 4) for lg in vt['logs']]}; the IBR "
        f"head's gradient norm by step "
        f"{['%.3g' % x for x in vt['mlp_tex_grad_norm']]}; two steps from "
        f"one state equal to the bit ({vt['repeat']['n_params']} "
        f"parameters)")
    say(f"phase 9d the entry point on a two-view config (train.main on the "
        f"card, 256^2 subdiv 3, one frame x 2 cameras): one epoch of fit, 2 "
        f"steps and val_fn, {ve['fit_s']:.1f} s (val_total_loss "
        f"{ve['val_total_loss']}); --run_val on its checkpoint, 4 frames, "
        f"{ve['run_val_s']:.1f} s, psnr {ve['report']['psnr']}, ssim "
        f"{ve['report']['ssim']}; every query at two views; launches "
        f"{ {k: v for k, v in ve['launches'].items() if v} }; the phase "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(kernels=vk, serve=vf, train=vt, entry_point=ve,
                phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 10: the offline preprocessor's device work and the config variants
# ---------------------------------------------------------------------------

# 10a: InterHand2.6M's raw image size and the raw fixture's four cameras
# (tests/test_preprocess_pipeline.py: campos (40 i - 60, 10 i, 0) mm, no
# rotation, the hands 1.1 m in front), at a focal length that frames them
PREP_H, PREP_W = 512, 334
PREP_FOCAL = 1200.0
PREP_CAMS = 4
PREP_ROUNDS = 5
# 10b-10c: the variants' 8x8-ray patches card vs CPU (phase 4's tolerance
# with its certified visibility ties) and their G = 16 frames
VARIANT_RAYS = 8
VARIANT_G = 16
SP_VARIANTS = ("z", "ixyz", "cxyz", "wxyz", "mxyz", "rel_z", "rel_cxyz",
               "rel_wxyz", "rel_mxyz")
ACTIVATIONS = ("leakyrelu", "elu", "tanh", "sigmoid", "relu")
# the model transform of mxyz / rel_mxyz: a rotation about z and a shift
MODEL_T = [[0.8, -0.6, 0.0, 0.05], [0.6, 0.8, 0.0, -0.02],
           [0.0, 0.0, 1.0, 0.3], [0.0, 0.0, 0.0, 1.0]]
REMAT_MODES = (1, 2)
TWO_RES_ROUNDS = 2


def phase_preprocess(dev) -> dict:
    """Phase 10a: the preprocessor's device work on each of the raw
    fixture's cameras at InterHand2.6M's raw size, the two synthetic MANO
    hands of :func:`mano_hands_mesh` 1.1 m in front of them
    (``dataset_process.render_view``: kernel C, then the colours
    interpolated on the card): mask, densepose, bbox and the crop's
    intrinsics equal to the bit to the CPU port's, one launch of kernel C a
    view; ms a view (median of PREP_ROUNDS, the host's projection and the
    copies included) and kernel C alone on the view's faces beside the
    issue-rate bound of its work (``raster_work``)."""
    import numpy as np
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import dataset_process as dp
    from vanerf_tpu_torch.ops import rasterize
    verts, faces = mano_hands_mesh()
    verts = (verts + np.array([0.0, 0.0, 1.1], np.float32)).astype(np.float32)
    img = np.random.RandomState(SEED).randint(
        30, 230, (PREP_H, PREP_W, 3)).astype(np.uint8)
    K = np.array([[PREP_FOCAL, 0, PREP_W / 2], [0, PREP_FOCAL, PREP_H / 2],
                  [0, 0, 1]], np.float32)
    R = np.eye(3, dtype=np.float32)
    views = []
    for i in range(PREP_CAMS):
        campos = np.array([40.0 * i - 60.0, 10.0 * i, 0.0], np.float32) / 1e3
        t = -R @ campos
        ops.reset_launches()
        card = dp.render_view(img, verts, faces, K, R, t, dev)
        launches = ops.launch_counts()["rasterize"]
        cpu = dp.render_view(img, verts, faces, K, R, t, torch.device("cpu"))
        check(card is not None and cpu is not None, f"camera {i}: no pixel")
        for k in ("mask", "densepose", "bbox", "K_c"):
            check(np.array_equal(card[k], cpu[k]),
                  f"camera {i}: {k} on the card differs from the CPU's")
        check(launches == 1, f"camera {i}: {launches} launches of kernel C")
        ms = sorted(bench.timed(lambda: dp.render_view(img, verts, faces, K,
                                                       R, t, dev), dev)
                    for _ in range(PREP_ROUNDS))
        xy, z = dp.project(verts, K, R, t)
        tri = rasterize._packed_faces(torch.from_numpy(xy).to(dev),
                                      torch.from_numpy(z).to(dev),
                                      torch.from_numpy(faces).to(dev))
        face, zbuf = rasterize.raster_cuda(tri, PREP_H, PREP_W)
        work = rasterize.raster_work(tri.cpu(), PREP_H, PREP_W)
        views.append(dict(
            hit_share=float((card["mask"] > 0).mean()),
            densepose_nonzero=float((card["densepose"] > 0).any(-1).mean()),
            bbox=card["bbox"].tolist(), launches=launches,
            view_ms=ms[len(ms) // 2],
            kernel_ms=cuda_ms(lambda: rasterize.raster_cuda(tri, PREP_H,
                                                            PREP_W), 20),
            kernel_device_ms=graph_ms(lambda: rasterize.raster_cuda(
                tri, PREP_H, PREP_W)),
            raster_work=work,
            work_issue_bound_ms=issue_bound_ms(
                work["tests"] * RASTER_TEST_OPS
                + work["certified"] * 2 * RASTER_CERT_F64_OPS
                + work["pairs"] * RASTER_PAIR_ISSUE),
            **least_time(nbytes(tri, face, zbuf),
                         RASTER_OPS * work["pairs"])))
    return {"shape": f"{PREP_H}x{PREP_W} pixels x {faces.shape[0]} faces",
            "views": views}


def variant_cfg(cfg, **edits):
    """A copy of ``cfg`` with ``models.VANeRF``'s entries at the dotted
    paths of ``edits`` (``"sp_args.sp_type"``: "mxyz") replaced."""
    out = copy.deepcopy(cfg)
    for path, value in edits.items():
        d = out["models"]["VANeRF"]
        *head, last = path.split(".")
        for k in head:
            d = d[k]
        d[last] = value
    return out


def variant_frame(model, b, switches) -> dict:
    """One 256^2 frame at tile_group VARIANT_G under ``switches``: its ms,
    peak memory and launches, then one more under torch.profiler (device
    ops and busy ms)."""
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import renderer as tr

    def frame():
        return tr.render_full_image(model, b, level=3, sample_per_ray_c=S_C,
                                    sample_per_ray_f=S_F,
                                    tile_group=VARIANT_G)

    dev = b["verts"].device
    with env(**switches):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        out = {}
        ms = bench.timed(lambda: out.update(frame()), dev)
        res = dict(ms=ms, peak_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=ops.launch_counts(),
                   **bench.device_profile(frame, dev))
    check(torch.isfinite(out["tex_fg_fine"]).all().item()
          and out["alpha_fine"].max().item() > 0.2,
          f"variant frame {switches}: non-finite or empty")
    return res


def variant_patch(model, b, cached_cpu, switches, tag) -> dict:
    """An 8x8-ray patch of ``model`` on the card against the CPU port's
    under ``switches`` (:func:`patch_card_vs_cpu_ties`, phase 4's
    tolerance), the CPU side on ``cached_cpu`` (its encode, shared by the
    variants whose encoders are the default's; None: its own)."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    gen = torch.Generator().manual_seed(SEED + 5)
    grids = tr.mask_centered_grid(gen, b["tar_mask"][..., 0].cpu(),
                                  VARIANT_RAYS, VARIANT_RAYS)
    with env(**switches):
        return patch_card_vs_cpu_ties(model, b, grids, tag=tag,
                                      cached_cpu=cached_cpu)


def phase_variants(model, b, batch_np, cfg, dev) -> dict:
    """Phases 10b and 10c at full width: each of the nine other sp_types
    (mxyz / rel_mxyz with the batch's MODEL_T), VANERF_PE_DIRECT=1, the five
    other activations, [max, mean, var] pooling and the texture encoder's
    group / none norms, each a model built from the config
    (:func:`variant_model`: the default's weights where the shapes agree):
    an 8x8-ray patch on the card against the CPU port's; for 10b also the
    G = 16 frame's ms, busy ms, device ops and peak beside the default
    frame's in the same run."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    _model_cpu, _b_cpu, cached_cpu = cpu_side(model, batch_np)
    bT = dict(b, model_T=torch.tensor([MODEL_T], device=dev))
    res = {"frames": {"default": variant_frame(model, b, {})},
           "patches": {}}
    cases = [(f"sp_type {t}", dict(**{"sp_args.sp_type": t}), {})
             for t in SP_VARIANTS]
    cases.append(("VANERF_PE_DIRECT=1", {}, {"VANERF_PE_DIRECT": "1"}))
    cases += [(f"nl_layer {a}", {"mlp_geo_args.nl_layer": a}, {})
              for a in ACTIVATIONS]
    cases.append(("pool_types [max, mean, var]",
                  {"mlp_geo_args.pool_types": ["max", "mean", "var"]}, {}))
    cases += [(f"tex norm {n}", {"tex_args.norm": n}, {})
              for n in ("group", "none")]
    for i, (tag, edits, switches) in enumerate(cases):
        m = (variant_model(model, variant_cfg(cfg, **edits), SEED + 20 + i)
             if edits else model)
        model_space = "mxyz" in tag
        bb = bT if model_space else b
        own_encode = tag.startswith("tex norm")
        with torch.no_grad():
            r = variant_patch(m, bb, None if own_encode else cached_cpu,
                              switches, tag)
            if tag.startswith(("sp_type", "VANERF_PE")):
                res["frames"][tag] = variant_frame(m, bb, switches)
        res["patches"][tag] = r
        if model_space:
            try:
                with torch.no_grad():
                    tr.render_patch(m, b, grids=torch.full(
                        (1, 4, 2), 128.0, device=dev), out_h=2, out_w=2,
                        sample_per_ray_c=S_C, sample_per_ray_f=S_F,
                        compute_vis_map=False)
                raised = False
            except ValueError:
                raised = True
            check(raised, f"{tag}: no ValueError without model_T")
        del m
    return res


def phase_remat_train(model, batch, cfg, dev, train) -> dict:
    """Phase 10d: TRAIN_STEPS faithful GAN steps under each
    VANERF_REMAT_QUERY mode, from phase 5's seeded weights and draws: every
    loss equal to the bit to phase 5's, ms/step and peak beside them."""
    res = {}
    for mode in REMAT_MODES:
        with env(VANERF_REMAT_QUERY=str(mode)):
            r = phase_train(model, batch, cfg, dev)
        for i, (a, b_) in enumerate(zip(r["logs"], train["logs"])):
            check(a == b_, f"VANERF_REMAT_QUERY={mode} step {i}: logs "
                  f"{a} differ from phase 5's {b_}")
        res[mode] = r
    return res


def phase_two_res(model, b, cfg, dev) -> dict:
    """Phase 10e: VANERF_TWO_RES=1 on the shipped config (its 64^2 texture
    map under the 128^2 fine geometry map) and on a coarser-texture config
    (``tex_args.n_upsample: 1``, a 32^2 map): each model's frame against
    its frame without the switch on one encode (held as phase 3b holds the
    fused frames: a coarse sample may differ by ~1 ulp near a coarse cell's
    edge), ms in turns, and the launches of kernel 10, which also gathers
    the packed table with the switch (two a pass: the vertex table's and
    the map's)."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    models = {"shipped": model,
              "tex n_upsample 1": variant_model(
                  model, variant_cfg(cfg, **{"tex_args.n_upsample": 1}),
                  SEED + 40)}
    res = {}
    for tag, m in models.items():
        with torch.no_grad():
            fg, ft, _ = tr.encode_frame(m, b)
            check(ft.shape[1] < fg[1].shape[1], f"{tag}: texture map "
                  f"{ft.shape} not coarser than the fine geometry map "
                  f"{fg[1].shape}")
            outs = {}
            r = {"on": dict(frame_ms=[]), "off": dict(frame_ms=[])}
            with shared_encode(m, b):
                for _ in range(TWO_RES_ROUNDS):
                    for name, val in (("on", "1"), ("off", "0")):
                        out, ms, launches = timed_frame(
                            m, b, {"VANERF_TWO_RES": val})
                        r[name]["frame_ms"].append(ms)
                        r[name]["launches"] = launches
                        outs[name] = out
        check(r["on"]["launches"]["row_gather"] == 64
              and r["off"]["launches"]["row_gather"] == 32,
              f"{tag}: kernel 10 launches {r['on']['launches']['row_gather']}"
              f" / {r['off']['launches']['row_gather']}")
        worst, share, abs_err = hold_to_fused_bounds(
            f"VANERF_TWO_RES=1 {tag}", [outs["on"]], [outs["off"]])
        r.update(tex_map=list(ft.shape[1:3]),
                 geo_fine_map=list(fg[1].shape[1:3]), of_bound=worst,
                 share_outside=share, max_abs_err=abs_err,
                 max_abs_diff=max((outs["on"][k] - outs["off"][k]).abs()
                                  .max().item() for k in outs["on"]
                                  if torch.is_tensor(outs["on"][k])
                                  and outs["on"][k].is_floating_point()))
        res[tag] = r
    return res


def phase_bf16_other_widths(model16, b, cfg, dev) -> dict:
    """Phase 10f: the bfloat16 frame of a model at BF16_OTHER_WIDTHS under
    VANERF_FUSED_MLP=1 and =2: the mma.sync body runs (32 launches a
    frame), the wgmma body and the float32 kernels do not; outputs finite,
    within phase 3h's PSNR floor of the same model's unfused frame."""
    import torch
    m = bf16_other_width_model(model16, cfg)
    res = {}
    with torch.no_grad(), shared_encode(m, b):
        ref, _, _ = timed_frame(m, b, {})
        for level, kern in (("1", "fused_geo_mlp"), ("2", "fused_query_mlp")):
            out, ms, launches = timed_frame(m, b, {"VANERF_FUSED_MLP": level})
            check(launches[kern + "_bf16_mma"] == 32
                  and launches[kern + "_bf16"] == 0 and launches[kern] == 0,
                  f"VANERF_FUSED_MLP={level} at other widths: launches "
                  f"{launches}")
            check(torch.isfinite(out["tex_fg_fine"]).all().item(),
                  f"VANERF_FUSED_MLP={level} at other widths: non-finite")
            res[level] = dict(ms=ms, launches=launches,
                              psnr_vs_unfused=psnr(out["tex_fg_fine"],
                                                   ref["tex_fg_fine"]))
    return res


def run_phase_variants(model, model16, b, batch_np, cfg, dev, train) -> dict:
    """Phase 10 (10a-10f), each sub-phase's lines printed as it ends."""
    t0 = time.perf_counter()
    res = {"preprocess": phase_preprocess(dev)}
    for i, v in enumerate(res["preprocess"]["views"]):
        w_ = v["raster_work"]
        say(f"phase 10a preprocessor, camera {i} ({res['preprocess']['shape']}"
            f"): mask, densepose, bbox and K_c on the card equal to the "
            f"CPU port's to the bit; {v['hit_share']:.3f} of the pixels "
            f"covered; kernel C {v['launches']} launch; the view's device "
            f"work {v['view_ms']:.2f} ms (median of {PREP_ROUNDS}, the "
            f"projection and copies included); kernel C alone "
            f"{v['kernel_ms']:.4f} ms called, {v['kernel_device_ms']:.4f} ms "
            f"device (CUDA graph), {w_['pairs']} (pixel, face) pairs walked "
            f"of {w_['tests']} (tile, face) tests: at the issue rate "
            f"{v['work_issue_bound_ms']:.4f} ms; bound {v['bound_ms']:.4f} "
            f"ms by {v['bound_by']}")
    say("phase 10a preprocessor: the raw read, the crop and the JPEG writes "
        "use PIL, which this machine lacks; they run on the host and are "
        "held by tests/test_torch_preprocess.py (byte-equal to the JAX "
        "preprocessor's files)")
    res["variants"] = phase_variants(model, b, batch_np, cfg, dev)
    fr = res["variants"]["frames"]
    for tag, p in res["variants"]["patches"].items():
        f = fr.get(tag)
        say(f"phase 10{'b' if f else 'c'} {tag}: 8x8-ray patch card vs CPU "
            f"max abs err {max(p['max_abs_err'].values()):.2g} "
            f"({p['ties']['differ']} certified visibility ties)"
            + (f"; G = {VARIANT_G} frame {f['ms']:.1f} ms, busy "
               f"{f['device_busy_ms']:.1f} ms, {f['device_ops']} device ops, "
               f"peak {f['peak_bytes'] / 2**30:.2f} GiB (default frame "
               f"{fr['default']['ms']:.1f} ms, busy "
               f"{fr['default']['device_busy_ms']:.1f}, "
               f"{fr['default']['device_ops']} ops, "
               f"{fr['default']['peak_bytes'] / 2**30:.2f} GiB)" if f else ""))
    res["remat"] = phase_remat_train(model, b, cfg, dev, train)
    for mode, r in res["remat"].items():
        say(f"phase 10d VANERF_REMAT_QUERY={mode}: {TRAIN_STEPS} faithful "
            f"GAN steps, every loss equal to the bit to phase 5's; "
            f"{r['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}; all "
            f"{[round(t, 1) for t in r['step_ms']]}) against phase 5's "
            f"{train['ms_per_step']:.1f}; peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB against {train['peak_bytes'] / 2**30:.2f}")
    res["two_res"] = phase_two_res(model, b, cfg, dev)
    for tag, r in res["two_res"].items():
        say(f"phase 10e VANERF_TWO_RES=1, {tag} (texture map {r['tex_map']} "
            f"under the fine geometry map {r['geo_fine_map']}): full image "
            f"in turns {' / '.join(f'{t:.1f}' for t in r['on']['frame_ms'])}"
            f" ms against "
            f"{' / '.join(f'{t:.1f}' for t in r['off']['frame_ms'])} "
            f"without; max abs diff {r['max_abs_diff']:.3g}; coarse outputs "
            f"at most {max(r['of_bound'][k] for k in COARSE_KEYS):.3g} of "
            f"rtol {FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it "
            f"on {max(r['share_outside'].values()):.3%}; kernel 10 launches "
            f"{r['on']['launches']['row_gather']} / "
            f"{r['off']['launches']['row_gather']}")
    res["bf16_other_widths"] = r = phase_bf16_other_widths(model16, b, cfg,
                                                           dev)
    for level, x in r.items():
        kern = "fused_geo_mlp" if level == "1" else "fused_query_mlp"
        say(f"phase 10f bfloat16 at widths {BF16_OTHER_WIDTHS} under "
            f"VANERF_FUSED_MLP={level}: {x['ms']:.1f} ms a frame, "
            f"{kern}_bf16_mma {x['launches'][kern + '_bf16_mma']} launches "
            f"(the wgmma body {x['launches'][kern + '_bf16']}); PSNR against "
            f"the unfused bfloat16 frame {x['psnr_vs_unfused']:.2f} dB")
    res["phase_s"] = time.perf_counter() - t0
    say(f"phase 10: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 11: the dense voxel branch (sp_conv: true) at full width
# ---------------------------------------------------------------------------

SP_GRID = (64, 64, 64)
SP_TILE_GROUPS = (1, 16)
SP_ROUNDS = 1
# under sp_conv the network's second output is the density itself (no
# mesh prior): at seeded weights it is ~1 / m and the frame nearly empty,
# so phase 11 offsets its bias to 60 / m, a sample ~4 mm deep then taking
# ~20% of a ray
SP_DENSITY_BIAS = 60.0
# 11e: the G-loss gradient card vs CPU under phase 6's bounds, the CPU's
# voxel branches in float64, and those branches and the encoders behind
# them to a relative norm error of SP_LOOSE_RTOL.  Their gradients are
# ill-conditioned in float32: the CPU's float32 geometry U-nets lie up to
# 1.2e-1 off the same branch in float64 in their smallest tensors (the
# card's 2e-5 there, 4.6e-3 at worst), and in the texture branch's gate a
# few LayerNorm rows over near-zero features (eps 1e-6 above their
# variance) turn the last-bit differences of cuBLAS's and MKL's products
# into flipped ReLUs and 1.8e-2 in the texture U-net, the same with every
# kernel replaced by its plain version (on an H100, see PERF.md)
SP_LOOSE_PATH = ("geo_encoder.", "tex_encoder.", "geo_vis_fusion.",
                 "tex_vis_fusion.")
SP_LOOSE_RTOL = 1e-1


def sp_model(model, cfg):
    """configs/vanerf.json under ``sp_conv: true`` on the 64^3 grid, built
    as phase 10 builds its variants (:func:`variant_model`: the default's
    encoders, MLP and IBR head; the voxel fusion modules seeded), the
    density's bias offset by SP_DENSITY_BIAS."""
    import torch
    m = variant_model(model, variant_cfg(cfg, sp_conv=True,
                                         voxel_grid=list(SP_GRID)),
                      SEED + 40)
    with torch.no_grad():
        m.mlp_geo.layers2.layers[-1].linear.bias[1] += SP_DENSITY_BIAS
    return m


def sp_frames(m, model, b, b2, dev) -> dict:
    """Phase 11b / 11c: the 256^2 frame under sp_conv at each G of
    SP_TILE_GROUPS (the first frame's ms, peak and launches, SP_ROUNDS
    rounds in turns with the default model's frame at the same G, device
    ops and busy ms of one more), the G = 16 frame held to the G = 1 frame
    as phase 3i holds them, and one two-view frame at G = 16."""
    import torch
    from vanerf_tpu_torch import bench, ops
    from vanerf_tpu_torch import renderer as tr

    def frame(net, G, batch=b, n_views=1):
        return tr.render_full_image(net, batch, level=3, sample_per_ray_c=S_C,
                                    sample_per_ray_f=S_F, n_views=n_views,
                                    tile_group=G)

    runs, outs = {}, {}
    for G in SP_TILE_GROUPS:
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs[G] = frame(m, G)
        torch.cuda.synchronize()
        runs[G] = dict(first_ms=(time.perf_counter() - t0) * 1e3,
                       peak_bytes=torch.cuda.max_memory_allocated(dev),
                       launches=ops.launch_counts(), frame_ms=[],
                       default_ms=[])
        # the mesh priors are the default path's: 2 s^2 / G passes of A and
        # B, the vertex visibility's one C; the voxel branch adds three
        # gathers of KNN rows a pass (kernel 10) and no kernel 13
        want = {"mesh_query": 32 // G, "knn": 32 // G, "rasterize": 1,
                "row_gather": 3 * 32 // G, "onehot_scatter": 0}
        for name, n in want.items():
            got = runs[G]["launches"][name]
            check(got == n, f"sp_conv, tile_group={G}: {got} launches of "
                  f"{name} a frame, not {n}")
        check(torch.isfinite(outs[G]["tex_fg_fine"]).all().item()
              and outs[G]["alpha_fine"].max().item() > 0.2,
              f"sp_conv frame at G = {G}: non-finite or empty")
        runs[G]["alpha_fine_max"] = outs[G]["alpha_fine"].max().item()
    for _ in range(SP_ROUNDS):
        for G in SP_TILE_GROUPS:
            runs[G]["frame_ms"].append(bench.timed(lambda: frame(m, G), dev))
            runs[G]["default_ms"].append(bench.timed(
                lambda: frame(model, G), dev))
    for G in SP_TILE_GROUPS:
        runs[G].update(bench.device_profile(lambda: frame(m, G), dev))
    runs[16]["top_device_ms"] = top_device_ops(lambda: frame(m, 16), dev)
    for G in SP_TILE_GROUPS[1:]:
        worst, share, abs_err = hold_to_fused_bounds(
            f"sp_conv, tile_group={G}", [outs[G]], [outs[1]])
        runs[G].update(of_bound=worst, share_outside=share,
                       max_abs_err=abs_err)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out2 = {}
    ms2 = bench.timed(lambda: out2.update(frame(m, 16, b2, VIEWS)), dev)
    views = dict(ms=ms2, peak_bytes=torch.cuda.max_memory_allocated(dev),
                 launches=ops.launch_counts(),
                 **bench.device_profile(lambda: frame(m, 16, b2, VIEWS),
                                        dev))
    check(torch.isfinite(out2["tex_fg_fine"]).all().item()
          and out2["alpha_fine"].max().item() > 0.2,
          "sp_conv two-view frame: non-finite or empty")
    return dict(frames=runs, views=views)


def top_device_ops(fn, dev, n: int = 8) -> list:
    """``fn()`` once under ``torch.profiler``: the ``n`` operations with the
    most device time, (name, ms, calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count) for e in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def sp_scatter_check(captured) -> dict:
    """Phase 11d: kernel 13 on each (g, rows, table rows) that one sp_conv
    step handed it, to 1e-5 of the row's sum of |g| (phase 2's and 9a's
    bound) from the exact sums (float64), and two launches equal to the
    bit.  The reference is the exact sum, not the float32 plain version:
    the corner reads put up to 32,768 points on a row of a 4^3 volume, and
    index_add_'s float32 sum in atomic order strays past that bound itself
    (its distance is reported beside)."""
    import torch
    from vanerf_tpu_torch.ops import onehot_gather
    shapes, worst, worst_plain = {}, 0.0, 0.0
    for g, rows, T_ in captured:
        g, rows = g.contiguous(), rows.to(torch.int32).contiguous()
        got = onehot_gather.onehot_scatter_cuda(g, rows, T_)
        again = onehot_gather.onehot_scatter_cuda(g, rows, T_)
        want = onehot_gather.onehot_scatter_plain(g, rows, T_).double()
        exact = torch.zeros(T_, g.shape[1], dtype=torch.float64,
                            device=g.device).index_add_(0, rows.long(),
                                                        g.double())
        bound = onehot_gather.onehot_scatter_plain(g.abs(), rows,
                                                   T_).double()
        tag = f"{rows.shape[0]} rows into {T_}x{g.shape[1]}"
        check(torch.equal(got, again), f"phase 11d scatter not "
              f"deterministic ({tag})")
        e = (got.double() - exact).abs()
        check(bool((e <= 1e-5 * bound + 1e-30).all()),
              f"phase 11d scatter err {e.max().item()} ({tag})")
        if e.numel():
            worst = max(worst, (e / bound.clamp(min=1e-30)).max().item())
            worst_plain = max(worst_plain, ((want - exact).abs()
                                            / bound.clamp(min=1e-30))
                              .max().item())
        shapes[tag] = shapes.get(tag, 0) + 1
    torch.cuda.synchronize()
    return dict(calls=len(captured), shapes=shapes, rel_to_abs_sum=worst,
                plain_rel_to_abs_sum=worst_plain)


def sp_train(m, b, cfg, dev) -> dict:
    """Phase 11d: TRAIN_STEPS faithful GAN steps under sp_conv from the
    seeded weights and draws (ms/step, peak, launches, every loss and
    parameter finite, the voxel U-nets' gradients non-zero), kernel 13
    held to its plain version on what the first step handed it
    (:func:`sp_scatter_check`), then two steps from one state and one seed
    of draws, equal to the bit.  In turns with those steps, as many of a
    second trainer whose corner reads of the <= 16^3 volumes take the
    native gather instead of kernel 13 (``ops/voxel.py``): the route's
    A/B."""
    from vanerf_tpu_torch.ops import onehot_gather, voxel
    trainer = Trainer(m, b, cfg, dev)
    native = Trainer(m, b, cfg, dev)
    names = [n for n, _ in trainer.gen_model.named_parameters()]
    real, unet = trainer.state.opt_g.step, []

    def step(grads):
        unet.append(math.sqrt(sum(
            float(g.float().pow(2).sum()) for n, g in zip(names, grads)
            if ".xyzc" in n and g is not None)))
        real(grads)

    trainer.state.opt_g.step = step
    real_scatter, captured = onehot_gather.onehot_scatter, []

    def record(g, rows, n_rows):
        captured.append((g.detach().clone(), rows.clone(), n_rows))
        return real_scatter(g, rows, n_rows)

    real_route = voxel.take_rows_route

    def native_step():
        voxel.take_rows_route = lambda n_rows, src: False
        try:
            native.step()
        finally:
            voxel.take_rows_route = real_route

    onehot_gather.onehot_scatter = record
    try:
        trainer.step()
    finally:
        onehot_gather.onehot_scatter = real_scatter
    native_step()
    for _ in range(TRAIN_STEPS - 1):
        trainer.step()
        native_step()
    res = trainer.result()
    nat = native.result()
    check(nat["launches"]["onehot_scatter"] < res["launches"]
          ["onehot_scatter"], "sp_conv: the native corner reads launched "
          "kernel 13 as often")
    la = res["launches"]
    check(len(captured) * TRAIN_STEPS == la["onehot_scatter"],
          f"sp_conv training: {len(captured)} table gradients captured in "
          f"the first step, {la['onehot_scatter']} launches of kernel 13 in "
          f"{TRAIN_STEPS}")
    res["scatter"] = sp_scatter_check(captured)
    del captured
    res["native_corner_reads"] = dict(
        ms_per_step=nat["ms_per_step"], step_ms=nat["step_ms"],
        peak_bytes=nat["peak_bytes"],
        onehot_scatter=nat["launches"]["onehot_scatter"],
        g_loss=[lg["train/g_loss"] for lg in nat["logs"]])
    for name in ("mesh_query", "knn"):
        check(la[name] == 4 * TRAIN_STEPS, f"sp_conv training: {la[name]} "
              f"launches of {name}, not {4 * TRAIN_STEPS}")
    for name in ("rasterize", "onehot_scatter", "row_gather"):
        check(la[name] > 0, f"sp_conv training launched no {name}")
    check(len(unet) == TRAIN_STEPS and min(unet) > 0,
          f"sp_conv: the voxel U-nets' gradient norms {unet}")
    rep = repeat_step(m, b, cfg, dev)
    check(rep["bit_equal"], f"sp_conv train step does not repeat to the "
          f"bit: logs {rep['logs_differ']}, {len(rep['params_differ'])} "
          f"parameters, first output {rep['first_output_differing']}, "
          f"first gradient {rep['first_gradient_differing']}")
    res.update(unet_grad_norm=unet, repeat=rep)
    return res


def run_phase_sp(model, b, batch_np, cfg, dev) -> dict:
    """Phase 11 (sp_conv at full width): 11a an 8x8-ray patch card vs CPU,
    11b / 11c the frames, 11d training, 11e the G-loss gradient card vs
    CPU; each reported on its own lines."""
    import torch
    t0 = time.perf_counter()
    cfg_sp = variant_cfg(cfg, sp_conv=True, voxel_grid=list(SP_GRID))
    m = sp_model(model, cfg)
    check(m.sp_conv and m.voxel_grid == SP_GRID, "the sp_conv model")
    _model_cpu, _b_cpu, cached_cpu = cpu_side(model, batch_np)
    _b2_np, b2 = views_frame(dev)
    with torch.no_grad():
        patch = variant_patch(m, b, cached_cpu, {}, "sp_conv patch")
        fr = sp_frames(m, model, b, b2, dev)
    tr_res = sp_train(m, b, cfg_sp, dev)
    t_grad = time.perf_counter()
    m64 = copy.deepcopy(m).cpu()
    m64.geo_vis_fusion.double()
    m64.tex_vis_fusion.double()
    grad, _g_cpu = phase_train_card_vs_cpu(m, batch_np, cfg_sp, dev,
                                           loose=SP_LOOSE_PATH, cpu_model=m64)
    del m64
    grad["s"] = time.perf_counter() - t_grad
    say(f"phase 11a sp_conv ({SP_GRID[0]}^3 grid) {VARIANT_RAYS}x"
        f"{VARIANT_RAYS}-ray patch card vs CPU: "
        f"{ {k: f'{v:.2g}' for k, v in patch['max_abs_err'].items()} } "
        f"(rtol {TIER_CPU_RTOL} atol {TIER_CPU_ATOL}; {patch['ties']['differ']}"
        f" certified visibility ties taken from the card; alpha_fine max "
        f"{patch['alpha_fine_max']:.3g})")
    for G, r in fr["frames"].items():
        la = r["launches"]
        say(f"phase 11b sp_conv, tile_group={G}: full image "
            f"{r['first_ms']:.1f} ms first, "
            f"{' / '.join(f'{t:.1f}' for t in r['frame_ms'])} ms in turns "
            f"with the default frame's "
            f"{' / '.join(f'{t:.1f}' for t in r['default_ms'])}; peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['device_ops']} device "
            f"ops, busy {r['device_busy_ms']:.1f} ms (torch.profiler); "
            f"launches A {la['mesh_query']}, B {la['knn']}, C "
            f"{la['rasterize']}, D {la['interp_mxu']}, 10 {la['row_gather']}"
            f", 13 {la['onehot_scatter']}"
            + (f"; against G = 1: coarse outputs at most "
               f"{max(r['of_bound'][k] for k in COARSE_KEYS):.3g} of rtol "
               f"{FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it on "
               f"{max(r['share_outside'].values()):.3%} of their elements, "
               f"largest difference {max(r['max_abs_err'].values()):.3g}"
               if "of_bound" in r else ""))
    say("phase 11b sp_conv, tile_group=16, the operations with the most "
        "device time (torch.profiler, one frame): " + "; ".join(
            f"{name[:60]} {ms:.1f} ms / {calls}"
            for name, ms, calls in fr["frames"][16]["top_device_ms"]))
    v = fr["views"]
    say(f"phase 11c sp_conv two views, tile_group=16: full image "
        f"{v['ms']:.1f} ms; peak {v['peak_bytes'] / 2**30:.2f} GiB; "
        f"{v['device_ops']} device ops, busy {v['device_busy_ms']:.1f} ms; "
        f"launches { {k: n for k, n in v['launches'].items() if n} }")
    say(f"phase 11d sp_conv training ({TRAIN_STEPS} faithful GAN steps, "
        f"64x64 rays, 64+64 samples): {tr_res['ms_per_step']:.1f} ms/step "
        f"(steps 2-{TRAIN_STEPS}; all: "
        f"{[round(t, 1) for t in tr_res['step_ms']]}); peak "
        f"{tr_res['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{ {k: n for k, n in tr_res['launches'].items() if n} }; g_loss "
        f"{[round(lg['train/g_loss'], 4) for lg in tr_res['logs']]}; the "
        f"voxel U-nets' gradient norm by step "
        f"{['%.3g' % x for x in tr_res['unet_grad_norm']]}; two steps from "
        f"one state equal to the bit ({tr_res['repeat']['n_params']} "
        f"parameters); kernel 13 on the first step's "
        f"{tr_res['scatter']['calls']} table gradients "
        f"({tr_res['scatter']['shapes']}) within "
        f"{tr_res['scatter']['rel_to_abs_sum']:.2g} of the row's sum of |g| "
        f"from the exact sums (bound 1e-5; the float32 plain version "
        f"{tr_res['scatter']['plain_rel_to_abs_sum']:.2g}), two launches "
        f"equal to the bit; in turns, the corner "
        f"reads by the native gather: "
        f"{tr_res['native_corner_reads']['ms_per_step']:.1f} ms/step (all: "
        f"{[round(t, 1) for t in tr_res['native_corner_reads']['step_ms']]}"
        f"), peak "
        f"{tr_res['native_corner_reads']['peak_bytes'] / 2**30:.2f} GiB, "
        f"kernel 13 {tr_res['native_corner_reads']['onehot_scatter']} "
        f"launches, g_loss "
        f"{[round(x, 4) for x in tr_res['native_corner_reads']['g_loss']]}")
    say(f"phase 11e sp_conv G-loss gradient card vs CPU (16x16 rays, 64+64 "
        f"samples; the CPU's voxel branches in float64): loss {grad['loss_card']:.7g} / {grad['loss_cpu']:.7g} "
        f"(rel {grad['loss_rel_err']:.2e}, bound {CARD_CPU_LOSS_RTOL}); "
        f"gradients within {grad['worst_of_bound']:.2f} of their bound at "
        f"worst ({grad['worst_grad']}; rtol {CARD_CPU_GRAD_RTOL}, "
        f"{SP_LOOSE_RTOL} under {', '.join(SP_LOOSE_PATH)}); largest "
        f"relative norm error {grad['worst_grad_rel_err']:.2e} "
        f"({grad['worst_rel_grad']}); outside those prefixes "
        f"{grad['worst_tight_rel_err']:.2e} ({grad['worst_tight_grad']}); "
        f"{grad['s']:.1f} s; the phase {time.perf_counter() - t0:.1f} s")
    return dict(patch=patch, serve=fr, train=tr_res, grad_card_vs_cpu=grad,
                phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 12: data parallelism (vanerf_tpu_torch/parallel) on the one card
# ---------------------------------------------------------------------------

MESH_G = 16
# 12b: run_test on the fixture's test frame seen from this many cameras
MESH_VAL_CAMS = 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_draws(shard, seed: int) -> dict:
    """One rank's draws of a step at full width (G and D), from a seeded
    CPU generator."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    g = torch.Generator().manual_seed(seed)
    P = 64 * 64

    def one():
        return {"grids": tr.mask_centered_grid(
                    g, shard["tar_mask"][..., 0].cpu(), 64, 64).numpy(),
                "u_c": torch.rand(1, P, S_C, generator=g).numpy(),
                "noise_c": torch.randn(1, P * S_C, 1, generator=g).numpy(),
                "u_f": torch.rand(1, P, S_F, generator=g).numpy(),
                "noise_f": torch.randn(1, P * S_F, 1, generator=g).numpy()}
    return {"g": one(), "d": one()}


def mesh_parts(job, dev):
    """(generator, discriminator, VGG, train state) on ``dev`` from a
    phase-12 job's state dicts."""
    import torch
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF
    from vanerf_tpu_torch.training import create_train_state
    m = VANeRF.from_config(job["cfg"], num_v=job["num_v"], image_hw=(H, W))
    m.load_state_dict(job["model"])
    disc = DiscriminatorVis()
    disc.load_state_dict(job["disc"])
    vgg = VGGLoss(job["vgg"])
    m, disc, vgg = m.to(dev), disc.to(dev), vgg.to(dev)
    return m, disc, vgg, create_train_state(m, disc, job["cfg"])


def mesh_val(m, state, cfg, G, save_dir, dev, mesh=None):
    """Phase 12b: ``run_test`` (as ``--run_val`` calls it) on the fixture's
    test frame from MESH_VAL_CAMS cameras at ``eval_tile_group`` G; the
    report's mapping (None on a rank other than 0)."""
    from vanerf_tpu_torch.data import SyntheticDataset
    from vanerf_tpu_torch.eval_loop import run_test
    cfg = copy.deepcopy(cfg)
    cfg["training"]["eval_tile_group"] = G
    ds = SyntheticDataset(n_frames=1, n_cams=MESH_VAL_CAMS, split="test",
                          H=H, W=W, subdiv=SUBDIV, device=dev)
    return run_test(m, state, ds, cfg, save_dir, mesh=mesh)


def mesh_worker(rank, size, init, job_path):
    """Phase 12b, one of two gloo ranks on the card: the sharded G = 16
    frame and ``run_test(mesh=)`` at G = 16 (:func:`mesh_val`), then one
    data-parallel GAN step on this rank's frame with its draws; the frame,
    the report, the logs, the averaged gradients and the updated
    parameters (on the host) to ``<job>.<rank>``."""
    import torch
    sys.path.insert(0, REPO)
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.parallel import (make_mesh, make_parallel_train_step,
                                           shard_batch)
    mesh = make_mesh(size, device="cuda", rank=rank, init_method=init,
                     backend="gloo")
    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_path, weights_only=False)
    m, disc, vgg, state = mesh_parts(job, dev)
    batch = to_torch(job["batch"], dev)
    with torch.no_grad():
        frame = tr.render_full_image(
            m.eval(), {k: v[:1] if k not in ("faces", "znear", "zfar")
                       else v for k, v in batch.items()}, level=3,
            sample_per_ray_c=S_C, sample_per_ray_f=S_F, tile_group=MESH_G,
            mesh=mesh)
    report = mesh_val(m, state, job["cfg"], MESH_G,
                      os.path.join(os.path.dirname(job_path), "val_two"),
                      dev, mesh)
    m.train()
    seen = {}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        def hooked(grads, orig=opt.step, tag=tag):
            seen[tag] = [g.detach().cpu() for g in grads]
            orig(grads)
        opt.step = hooked
    step = make_parallel_train_step(m, disc, job["cfg"], vgg, mesh)
    logs = step(state, shard_batch(mesh, batch), draws=job["draws"][rank])
    torch.save({"frame": {k: v.cpu() for k, v in frame.items()},
                "report": report,
                "logs": {k: v.cpu() for k, v in logs.items()},
                "grads": seen,
                "model": {k: v.cpu() for k, v in m.state_dict().items()},
                "disc": {k: v.cpu() for k, v in disc.state_dict().items()}},
               f"{job_path}.{rank}")
    torch.distributed.destroy_process_group()


def mesh_one(model, b, cfg, dev) -> dict:
    """Phase 12a: NCCL at world size 1, set up as torchrun sets a rank up
    (RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, env://):
    the parallel GAN step (its all-reduces and first-step broadcast over
    NCCL) equals the plain step on the rank's folded generator to the bit,
    and render_full_image(mesh=) at G = 16 equals the plain frame to the
    bit."""
    import torch
    import torch.distributed as dist
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.parallel import (fold_generator, make_mesh,
                                           make_parallel_train_step)
    from vanerf_tpu_torch.training import create_train_state, make_train_step
    with env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port())):
        mesh = make_mesh(1)
    backend = mesh.backend
    try:
        check(backend == "nccl" and mesh.size == 1, f"phase 12a mesh {mesh}")
        out = {}
        for tag, use in (("mesh", mesh), ("plain", None)):
            gm, disc, vgg = train_parts(model, dev)
            state = create_train_state(gm, disc, cfg)
            gen = torch.Generator(device=dev).manual_seed(SEED + 50)
            if use is None:
                fn = make_train_step(gm, disc, cfg, vgg)
                gen = fold_generator(gen, 0, dev)
            else:
                fn = make_parallel_train_step(gm, disc, cfg, vgg, use)
            t0 = time.perf_counter()
            logs = fn(state, b, gen)
            torch.cuda.synchronize()
            out[tag] = dict(ms=(time.perf_counter() - t0) * 1e3, logs=logs,
                            params=[p.detach().clone() for net in (gm, disc)
                                    for p in net.parameters()])
        step_equal = (all(torch.equal(out["mesh"]["logs"][k], v)
                          for k, v in out["plain"]["logs"].items())
                      and all(torch.equal(x, y) for x, y in
                              zip(out["mesh"]["params"],
                                  out["plain"]["params"])))
        check(step_equal, "phase 12a: the NCCL step differs from the plain "
              "step")
        kw = dict(level=3, sample_per_ray_c=S_C, sample_per_ray_f=S_F,
                  tile_group=MESH_G)
        with torch.no_grad():
            want = tr.render_full_image(model, b, **kw)
            got = tr.render_full_image(model, b, mesh=mesh, **kw)
        frame_equal = set(got) == set(want) and all(
            torch.equal(got[k], v) for k, v in want.items())
        check(frame_equal, "phase 12a: the NCCL frame differs from the "
              "plain frame")
    finally:
        dist.destroy_process_group()
    return dict(backend=backend, step_ms=out["mesh"]["ms"],
                plain_step_ms=out["plain"]["ms"], step_equal=step_equal,
                frame_equal=frame_equal)


def mesh_two(model, batch_np, cfg, dev) -> dict:
    """Phase 12b: two gloo processes on the one card with the real kernels
    (NCCL will not put two ranks on one card): a 2-rank step on a global
    batch of the two fixture frames against this process computing each
    shard's step (gradients kept, none applied: the single-render GAN) and
    averaging, to the bit; the sharded G = 16 frame (8 offsets a rank)
    against the single-device frame at G = 8, to the bit, and at G = 16
    by phase 3i's rule (:func:`hold_to_fused_bounds`); rank 0's
    ``run_test(mesh=)`` report at G = 16 against this process's at G = 8,
    to the bit, rank 1 writing none.  The kernels are built before the
    ranks start (phase 1), so no two ranks build into one directory."""
    import tempfile
    from types import SimpleNamespace
    import torch
    import torch.multiprocessing as mp
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, init_like_flax
    from vanerf_tpu_torch.parallel import shard_batch
    from vanerf_tpu_torch.training import make_train_step
    cfg1 = copy.deepcopy(cfg)
    cfg1["training"]["reference_faithful_gan"] = False
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(SEED + 1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    b2 = to_torch(batch_np, "cpu")
    shards = [shard_batch(SimpleNamespace(rank=r, size=2), b2)
              for r in range(2)]
    job = dict(cfg=cfg1, num_v=model.num_v,
               model={k: v.cpu() for k, v in model.state_dict().items()},
               disc=disc.state_dict(), vgg=vgg.vgg_net.state_dict(),
               batch=batch_np,
               draws=[mesh_draws(shards[r], SEED + 60 + r) for r in range(2)])
    # the earlier phases' cached blocks back to the card, for the ranks
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mesh_") as d:
        path = os.path.join(d, "job.pt")
        torch.save(job, path)
        t0 = time.perf_counter()
        mp.start_processes(mesh_worker, args=(
            2, "file://" + os.path.join(d, "rendezvous"), path), nprocs=2,
            join=True, start_method="spawn")
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(f"{path}.{r}", weights_only=False)
                for r in range(2)]
    # this process: each shard's gradients and logs, then their average
    refs = []
    batch = to_torch(batch_np, dev)
    for r in range(2):
        m, dsc, vg, state = mesh_parts(job, dev)
        seen = {}
        state.opt_g.step = lambda g: seen.__setitem__("g", g)
        state.opt_d.step = lambda g: seen.__setitem__("d", g)
        logs = make_train_step(m, dsc, cfg1, vg)(
            state, shard_batch(SimpleNamespace(rank=r, size=2), batch),
            draws=job["draws"][r])
        refs.append((seen, logs))
    m, dsc, _vg, state = mesh_parts(job, dev)
    grads_equal = True
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        avg = [(torch.zeros_like(p) if a is None else a)
               for a, p in zip(refs[0][0][tag], opt.params)]
        avg = [(a + (torch.zeros_like(p) if c is None else c)) / 2
               for a, c, p in zip(avg, refs[1][0][tag], opt.params)]
        opt.step(avg)
        for o in outs:
            grads_equal &= all(torch.equal(x, y.cpu())
                               for x, y in zip(o["grads"][tag], avg))
    logs_equal = all(torch.equal(o["logs"][k], ((refs[0][1][k]
                                                 + refs[1][1][k]) / 2).cpu())
                     for o in outs for k in refs[0][1])
    params_equal = all(torch.equal(o[name][k], v.cpu())
                       for o in outs
                       for name, net in (("model", m), ("disc", dsc))
                       for k, v in net.state_dict().items())
    check(grads_equal and logs_equal and params_equal,
          f"phase 12b: the 2-rank step against the shards' average: "
          f"gradients {grads_equal}, logs {logs_equal}, parameters "
          f"{params_equal}")
    b1 = {k: v[:1] if k not in ("faces", "znear", "zfar") else v
          for k, v in batch.items()}
    kw = dict(level=3, sample_per_ray_c=S_C, sample_per_ray_f=S_F)
    with torch.no_grad():
        g8 = tr.render_full_image(model, b1, tile_group=MESH_G // 2, **kw)
        g16 = tr.render_full_image(model, b1, tile_group=MESH_G, **kw)
    frame_equal = all(torch.equal(o["frame"][k], v.cpu())
                      for o in outs for k, v in g8.items())
    check(frame_equal, "phase 12b: the sharded frame differs from the "
          "single-device frame at G = 8")
    # against the G = 16 frame as phase 3i holds G = 16 against G = 1: the
    # batch's size changes the rounding, and the fine pass's importance
    # samples move with it
    worst, share, errs = hold_to_fused_bounds(
        "phase 12b: the sharded frame against G = 16",
        [{k: v.to(dev) for k, v in outs[0]["frame"].items()}], [g16])
    m, _dsc, _vg, state = mesh_parts(job, dev)
    with tempfile.TemporaryDirectory(prefix="mesh_val_") as d:
        want = mesh_val(m.eval(), state, cfg1, MESH_G // 2, d, dev)
    got = outs[0]["report"]
    scores = ("psnr", "ssim", "mse")
    report_equal = (outs[1]["report"] is None and got is not None
                    and all(got[k] == want[k] for k in scores))
    check(report_equal and all(math.isfinite(want[k]) for k in scores),
          f"phase 12b: run_test(mesh=) reports {got} / "
          f"{outs[1]['report']} against one device's {want}")
    return dict(ranks_s=ranks_s, grads_equal=grads_equal,
                report_equal=report_equal,
                report={k: want[k] for k in scores},
                logs_equal=logs_equal, params_equal=params_equal,
                frame_equal_g8=frame_equal, vs_g16_of_bound=worst,
                vs_g16_share_outside=share, vs_g16_max_abs_err=errs,
                g_loss=[float(o["logs"]["train/g_loss"]) for o in outs])


def run_phase_mesh(model, b, batch_np, cfg, dev) -> dict:
    """Phase 12: 12a NCCL at world size 1, 12b two gloo ranks."""
    t0 = time.perf_counter()
    one = mesh_one(model, b, cfg, dev)
    two = mesh_two(model, batch_np, cfg, dev)
    say(f"phase 12a NCCL at world size 1 (env:// as torchrun sets it up): "
        f"the parallel GAN step (all-reduces and broadcast over NCCL) equal "
        f"to the bit to the plain step on the folded generator "
        f"({one['step_ms']:.1f} ms against {one['plain_step_ms']:.1f}, "
        f"first steps); render_full_image(mesh=) at G = {MESH_G} equal to "
        f"the bit to the plain frame")
    say(f"phase 12b two gloo ranks on the one card ({two['ranks_s']:.1f} s "
        f"the two processes, start to join): the 2-rank step on a global "
        f"batch of 2 equal to the bit to this process's average of the two "
        f"shards' steps (gradients, logs, parameters after Adam, on both "
        f"ranks; g_loss {two['g_loss']}); the sharded G = {MESH_G} frame "
        f"equal to the bit to the single-device G = {MESH_G // 2} frame, "
        f"and run_test(mesh=) on {MESH_VAL_CAMS} test views (rank 0's "
        f"report, psnr {two['report']['psnr']:.6g}) to one device's; "
        f"against the G = {MESH_G} frame (phase 3i's rule) coarse outputs "
        f"at most {max(two['vs_g16_of_bound'][k] for k in COARSE_KEYS):.3g}"
        f" of rtol {FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it "
        f"on {max(two['vs_g16_share_outside'].values()):.3%} of their "
        f"elements, largest difference "
        f"{max(two['vs_g16_max_abs_err'].values()):.3g}; NCCL cannot put "
        f"two ranks on one card, so N >= 2 over NCCL is "
        f"not run here; the phase {time.perf_counter() - t0:.1f} s")
    return dict(one=one, two=two, phase_s=time.perf_counter() - t0)


def main() -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device; the port's kernels need a GPU")
        return 1
    if not os.path.isdir(os.path.join(REPO, "vanerf_tpu_torch", "csrc")):
        say("FAIL: run chip_smoke.py from a checkout of the repository")
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")

    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import _cuda

    # ---- phase 1: build ----
    t_start = t0 = time.perf_counter()
    prebuilt = _cuda.library_path().exists()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say(f"phase 1 build: {os.path.basename(lib_path)} ready in "
        f"{build_s:.1f} s (compiled: {not prebuilt})")
    say(smi[0] if smi else "nvidia-smi: no output")

    # ---- fixture + model (seeded, full width) ----
    cfg = default_cfg()
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=2, H=H, W=W, subdiv=SUBDIV, device=dev)
    frames = []
    for i in range(2):
        fb = {k: (v[i:i + 1] if k not in ("faces", "znear", "zfar") else v)
              for k, v in batch_np.items()}
        frames.append(fb)
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(H, W))
    init_like_flax(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    batches = [to_torch(fb, dev) for fb in frames]
    say(f"fixture: {H}x{W}, {batches[0]['verts'].shape[1]} vertices, "
        f"{batches[0]['faces'].shape[0]} faces; model "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # ---- phase 2 ----
    with torch.no_grad():
        kres = phase_kernels(model, batches[0], dev)
    for name, r in kres.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        say(f"phase 2 {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3g}"
            f", kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library call "
            f"{lib}"
            + (f"; the sweep over every pair {r['brute_ms']:.3f} ms in turns, "
               f"bound over every pair {r['all_pairs']['bound_ms']:.4f} ms"
               if "brute_ms" in r else "")
            + (f"; device (CUDA graph) {r['device_ms']:.4f} ms, bound at the "
               f"issue rate {r['issue_bound_ms']:.4f} ms"
               if "issue_bound_ms" in r else "")
            + (f"; the faces it evaluates ({r['work']['evaluated']} of "
               f"{r['work']['sphere_tests']} (thread, face) pairs past the "
               f"sphere test) at the issue rate "
               f"{r['work_issue_bound_ms']:.4f} ms"
               if "work" in r else ""))
    r = kres["rasterize"]
    for tag, c in r["cases"].items():
        say(f"phase 2 rasterize [{tag}]: {c['shape']}: face and zbuf equal "
            f"to the sweep over every face; {c['hit_share']:.3f} of the "
            f"pixels hit, {c['kept_share']:.4f} of the (tile, face) tests "
            f"keep the face, {c['pair_share']:.4f} of the sweep's (pixel, "
            "face) pairs walked")
    w_ = r["raster_work"]
    say(f"phase 2 rasterize: kernel {r['ms']:.4f} ms called, "
        f"{r['device_ms']:.4f} ms on the device (CUDA graph); an empty "
        f"kernel {r['empty_ms']:.4f} / {r['empty_device_ms']:.4f} ms; "
        f"{w_['tests']} (tile, face) tests ({w_['certified']} through the "
        f"float64 certificate), {w_['pairs']} (pixel, face) pairs walked: "
        f"at the issue rate {r['work_issue_bound_ms']:.4f} ms; the sweep's "
        f"pairs at the f32 rate {r['all_pairs']['bound_ms']:.4f} ms; "
        f"ptxas {r['ptxas'] or 'not compiled in this run'}")
    for name in ("fused_geo_mlp", "fused_query_mlp"):
        r = kres[name]
        say(f"phase 2 {name}: {r['of_bound']:.3g} of rtol {FUSED_RTOL} atol "
            f"{FUSED_ATOL} at worst; kernel {r['ms']:.3f} ms called, "
            f"{r['device_ms']:.3f} ms on the device (CUDA graph); bound "
            f"{r['bound_ms']:.3f} ms in f32, {r['tensor_bound_ms']:.3f} ms "
            f"with 3xTF32 on the tensor cores; ptxas (the kernel and the "
            f"layer functions, largest) {r['ptxas']}")
    for name, lib in (("interp_mxu", "F.grid_sample"),
                      ("bilinear", "F.grid_sample"),
                      ("onehot_scatter", "index_add_ into a zeroed table")):
        for tag, c in kres[name]["cases"].items():
            say(f"phase 2 {name} [{tag}]: {c['shape']}"
                + (f", {c['path']}" if "path" in c else "")
                + f", {c['lanes']} lanes"
                f"{', in the kernels line' if c['summed'] else ''}: kernel "
                f"{c['ms']:.4f} ms, "
                + (f"plain {c['plain_ms']:.4f} ms, " if name == "bilinear"
                   else "")
                + f"{lib} {c['library_ms']:.4f} ms called in "
                f"the same run (device time from a CUDA graph "
                f"{c['device_ms']:.4f} / {c['library_device_ms']:.4f} ms), "
                f"bound "
                f"{c['bound_ms']:.4f} ms by {c['bound_by']}; "
                f"max_abs_err {c['max_abs_err']:.3g}"
                + (f" ({c['rel_to_abs_sum']:.2g} of the row's sum of |g|); "
                   f"index_add_ alone into a table allocated ahead "
                   f"{c['bare_library_device_ms']:.4f} ms device"
                   if "rel_to_abs_sum" in c else "")
                + "; bit-equal across two runs")
    for name in ("knn_culled", "knn_T_culled"):
        r = kres[name]
        say(f"phase 2 {name}: the chunk-box kernel it launches in front "
            f"of the search, alone: {r['boxes_ms']:.4f} ms called, "
            f"{r['boxes_device_ms']:.4f} ms device, equal to "
            f"vertex_chunk_boxes; ptxas (knn_culled_kernel) "
            f"{ptxas_text(r['ptxas'])}")
    for name in ("mesh_query_brute", "mesh_query_vis_brute"):
        r = kres[name]
        w_ = r["brute_work"]
        for mode, d in r["detail"].items():
            say(f"phase 2 {name} [{mode}]: kernel {d['ms']:.3f} ms called, "
                f"{d['device_ms']:.3f} ms device (CUDA graph); bound "
                f"{d['bound_ms']:.3f} ms (every pair's full evaluation at the "
                f"f32 rate); the work it does at the issue rate "
                f"{d['work_issue_bound_ms']:.3f} ms ({w_['evaluated']} of "
                f"{w_['sphere_tests']} (thread, face) pairs evaluated past "
                f"the sphere test, "
                f"{w_['evaluated'] / max(w_['sphere_tests'], 1):.3f})")
        say(f"phase 2 {name}: ptxas (mesh_query_brute_kernel, the six "
            f"instantiations, largest) {ptxas_text(r['ptxas'])}")
    for name in ("knn_culled", "knn_T_culled"):
        c = kres[name]["coherent"]
        say(f"phase 2 {name} [points and vertices in Morton order]: equal to "
            f"kernel B bit for bit; {c['visit_share']:.3f} of the (tile, "
            f"chunk) pairs visited, {c['tiles_skipping']} tiles skip a chunk; "
            f"culled {c['ms']:.3f} ms, kernel B {c['brute_ms']:.3f} ms in "
            f"turns")
    r = kres["knn_culled"]["mano"]
    for name in ("knn_culled", "knn_T_culled"):
        c = r[name]
        say(f"phase 2 {name} [the MANO-ordered hands, {r['vertices']} "
            f"vertices in {r['chunks']} chunks]: equal to kernel B bit for "
            f"bit; {c['visit_share']:.3f} of the (tile, chunk) pairs visited, "
            f"{c['tiles_skipping']} tiles skip a chunk; culled {c['ms']:.3f} "
            f"ms, kernel B {c['brute_ms']:.3f} ms in turns; device (CUDA "
            f"graph) {c['device_ms']:.4f} / {c['brute_device_ms']:.4f} ms; "
            f"plain {c['plain_ms']:.3f} ms, torch.cdist + min "
            f"{c['library_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms by "
            f"{c['bound_by']}")
    for name in ("mesh_query", "mesh_query_T"):
        for tag, d in kres[name]["detail"].items():
            say(f"phase 2 {name} [{tag}]: culled {d['ms']:.3f} ms, sweep "
                f"{d['sweep_ms']:.3f} ms in turns; (tile, chunk) pairs "
                f"visited {d['dist_visit_share']:.3f} distance / "
                f"{d['wind_visit_share']:.3f} winding; tiles taking -d "
                f"{d['neg_tile_share']:.3f}, far {d['far_tile_share']:.3f}; "
                f"{d['wind_differs_from_sweep']} crossing counts differ from "
                f"the sweep's (grazes along -d, margin "
                f"{d['their_edge_margin']:.2g}); {d['tied_faces']} points "
                "take another face than the mesh-order table's (exact ties); "
                f"VANERF_CULL_EARLY=1 {d['early_ms']:.3f} ms in turns, equal "
                f"to its plain version, d2 and winding equal to the default "
                f"walk's, {d['early_ties']} points on another face of equal "
                "distance")
    say("phase 2 mesh_query at every tile x chunk size (far tier on): equal "
        "to the plain version and the sweep; ms "
        + ", ".join(f"{k} {v:.3f}"
                    for k, v in kres["mesh_query"]["sizes_ms"].items()))

    # ---- phase 2b: the bfloat16 forms ----
    model16 = bf16_model(model, cfg, num_v)
    with torch.no_grad():
        kres16 = phase_kernels_bf16(model16, batches[0], cfg, dev)
    kres.update(kres16)
    for tag, c in kres16["interp_mxu_bf16"]["cases"].items():
        say(f"phase 2b interp_mxu_bf16 [{tag}]: {c['shape']}, {c['lanes']} "
            f"lanes{', in the kernels line' if c['summed'] else ''}: equal "
            f"to its plain version and across two runs; kernel "
            f"{c['ms']:.4f} ms, F.grid_sample on the bfloat16 map (its "
            f"grid rounded to bfloat16) "
            f"{c['library_ms']:.4f} ms called (device time from a CUDA graph "
            f"{c['device_ms']:.4f} / {c['library_device_ms']:.4f} ms), plain "
            f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms by "
            f"{c['bound_by']}")
    for tag, c in kres16["onehot_scatter_bf16"]["cases"].items():
        c32 = kres["onehot_scatter"]["cases"].get(tag)
        say(f"phase 2b onehot_scatter_bf16 [{tag}]: {c['shape']} "
            f"({c['path']}, {c['lanes']} lanes"
            f"{', in the kernels line' if c['summed'] else ''}): equal to "
            f"the float32 kernel on the widened rows rounded once, and "
            f"across two runs; {c['share_rounded_apart']:.2e} of the "
            f"elements apart from its plain version, by at most "
            f"{c['max_units']:.2f} bfloat16 unit; kernel {c['ms']:.4f} ms "
            f"called, {c['device_ms']:.4f} ms device (CUDA graph)"
            + (f", the float32 form at this shape {c32['device_ms']:.4f} ms "
               "device" if c32 else "")
            + f"; plain (index_add_ of the widened rows + one cast, the "
            f"library call) {c['plain_ms']:.4f} / "
            f"{c['library_device_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms "
            f"by {c['bound_by']}")
    r = kres16["row_gather_bf16"]
    say(f"phase 2b row_gather_bf16: {r['shape']}: equal to table[idx]; "
        f"kernel {r['ms']:.4f} ms called, {r['device_ms']:.4f} ms device "
        f"(CUDA graph), index_select {r['library_ms']:.4f} / "
        f"{r['library_device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    for act_name, a in kres16["fused_act_bf16"].items():
        say(f"phase 2b fused MLP bfloat16 {act_name}: the kernels' device "
            f"function on all {a['inputs']} bfloat16 inputs equal to the "
            f"plain version's rounded result, bit for bit ({a['differ']} "
            f"differ; {a['nan']} NaN on both sides)")
    for name in ("fused_geo_mlp_bf16", "fused_query_mlp_bf16",
                 "fused_geo_mlp_bf16_mma", "fused_query_mlp_bf16_mma"):
        r = kres16[name]
        if r["threads"] is not None:
            say(f"phase 2b {name}: {r['threads']} threads a block, "
                f"{r['smem_bytes']} bytes of shared memory, "
                f"{r['blocks_per_sm']} block(s) an SM "
                "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        say(f"phase 2b {name}: {r['shape']}: max abs err per output "
            f"{['%.3g' % e for e in r['errors']]} against the plain version, "
            f"RMS {r['of_spread_rms']:.3g} x the RMS spread between two "
            f"summation orders of the plain version (bound "
            f"{FUSED_BF16_SPREAD_X} x; the plain version without its "
            f"bfloat16 roundings {r['control_of_spread_rms']:.3g} x); largest "
            f"{r['of_spread']:.3g} x the largest spread "
            f"({['%.3g' % e for e in r['spread']]}; that control "
            f"{r['control_of_spread']:.3g} x), {r['of_s16']:.3g} x the plain "
            f"version's bfloat16-vs-float32 spread (bound 2 x); kernel "
            f"{r['ms']:.3f} ms called, "
            f"{r['device_ms']:.3f} ms on the device (CUDA graph), plain "
            f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms by "
            f"{r['bound_by']} (bf16 tensor cores + the CUDA cores' f32 "
            f"work); ptxas (the kernel and the activations' fallbacks, "
            f"largest) {ptxas_text(r['ptxas'])}")

    # ---- phase 3 ----
    with torch.no_grad():
        main = phase_main_path(model, batches, dev)
    say(f"phase 3 main path: full image {main['frame_ms'][0]:.1f} / "
        f"{main['frame_ms'][1]:.1f} ms per frame; 16-patch group "
        f"{main['group_s'] * 1e3:.1f} ms = {main['ray_samples_per_s']:.4g} "
        f"ray-samples/s; launches {main['launches']}")

    # ---- phase 3a ----
    with torch.no_grad():
        enc = phase_encode_repeat(model, batches[0])
    say(f"phase 3a encode_frame twice: equal to the bit; without the cuDNN "
        f"pin the first leaf module whose output differs between two calls "
        f"is {enc['unpinned_first_differing_module']} (of "
        f"{enc['leaf_modules']}); encode {enc['pinned_median_ms']:.2f} ms "
        f"pinned against {enc['unpinned_median_ms']:.2f} ms without the pin "
        f"(median of {ENCODE_ROUNDS} in turns)")

    # ---- phase 3g ----
    with torch.no_grad():
        mxu = phase_mxu_interp_serving(model, batches[0])
    g_ = mxu["gather"]
    say("phase 3g the frame with kernel D and under VANERF_MXU_INTERP=0, in "
        f"turns: full image {' / '.join(f'{t:.1f}' for t in mxu['D']['frame_ms'])}"
        f" ms with D, {' / '.join(f'{t:.1f}' for t in g_['frame_ms'])} ms "
        f"without; launches of D a frame {mxu['D']['launches']} / "
        f"{g_['launches']}; coarse outputs at most "
        f"{max(g_['of_bound'][k] for k in COARSE_KEYS):.3g} of rtol "
        f"{MXU_RTOL} atol {MXU_ATOL}, fine outputs outside it on at most "
        f"{max(g_['share_outside'].values()):.3%} of their elements (max "
        f"abs err colour {g_['max_abs_err']['tex_fg_fine']:.3g}), at most "
        f"{max(mxu['pinned']['gather'].values()):.3g} of it with the fine "
        "depths pinned")

    # ---- phase 3b ----
    with torch.no_grad():
        fused = phase_fused_serving(model, batches[0], dev)
    for name in ("level2", "level1"):
        r, u = fused[name], fused["unfused"]
        say(f"phase 3b {name} {FUSED_CONFIGS[name]}: full image "
            f"{' / '.join(f'{t:.1f}' for t in r['frame_ms'])} ms per frame "
            f"(unfused, far tier off, in turns: "
            f"{' / '.join(f'{t:.1f}' for t in u['frame_ms'])}); 16-patch "
            f"group {' / '.join(f'{t:.1f}' for t in r['group_ms'])} ms "
            f"(unfused {' / '.join(f'{t:.1f}' for t in u['group_ms'])}); "
            f"coarse outputs at most "
            f"{max(r['of_bound'][k] for k in COARSE_KEYS):.3g}"
            f" of rtol {FUSED_RTOL} atol {FUSED_ATOL}; fine outputs outside "
            f"it on at most {max(r['share_outside'].values()):.3%} of their "
            f"elements (max abs err colour "
            f"{r['max_abs_err']['tex_fg_fine']:.3g}), and at most "
            f"{max(fused['pinned'][name].values()):.3g} of it with the fine "
            f"depths pinned; launches "
            f"{ {k: r['launches'][k] for k in FUSED_KERNELS[name]} }")

    # ---- phase 3h ----
    with torch.no_grad():
        bf16 = phase_bf16_serving(model, model16, batches[0], frames[0], dev,
                                  cfg, num_v)
    for name in BF16_CONFIGS:
        r = bf16[name]
        say(f"phase 3h bfloat16 {name} {BF16_CONFIGS[name] or ''}: full "
            f"image {' / '.join(f'{t:.1f}' for t in r['frame_ms'])} ms per "
            f"frame (float32 in turns: "
            f"{' / '.join(f'{t:.1f}' for t in r['f32_frame_ms'])}); PSNR "
            f"against the float32 frame {r['psnr_vs_f32']:.2f} dB (max abs "
            f"{r['max_abs_vs_f32']}); card vs CPU (8x8 rays) at most "
            f"{max(r['card_vs_cpu_of_bound'].values()):.3g} of 2 S + 1e-4 + "
            f"1e-3 |x|; RMS error / S_rms (bound, float32 control) "
            + ", ".join(f"{k} {v['err'] / v['S']:.3g} ({v['bound'] / v['S']:.3g}"
                        f", {v['control'] / v['S']:.3g})" if v["S"] > 0
                        else f"{k} S = 0"
                        for k, v in r["card_vs_cpu_rms"].items())
            + "; launches "
            f"{ {k: r['launches'][k] for k in BF16_KERNELS[name] + F32_FORMS} }")

    # ---- phase 3i ----
    with torch.no_grad():
        tg = phase_tile_group(model, batches, cfg, dev)
    for case, kr in tg["kernels"].items():
        n_frames, G = BATCH_CASES[case]
        say(f"phase 3i batched kernels [{case}: {G * n_frames} elements of "
            f"{n_frames} frame(s)]: {', '.join(kr)} each one launch, equal "
            "to the bit to the elements' own launches"
            + "".join(f"; {n} {r['batch_device_ms']:.4f} ms device for the "
                      f"batch, {r['element_device_ms']:.4f} for element 0 "
                      f"alone (x {r['elements']} = "
                      f"{r['element_device_ms'] * r['elements']:.4f}), bound "
                      f"{r['batch_bound_ms']:.4f} by {r['batch_bound_by']}"
                      for n, r in kr.items() if r))
    for G, r in tg["frames"].items():
        say(f"phase 3i tile_group={G}: full image {r['first_ms']:.1f} ms "
            f"first, {' / '.join(f'{t:.1f}' for t in r['frame_ms'])} ms in "
            f"turns; peak {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"{r['device_ops']} device ops, busy {r['device_busy_ms']:.1f} "
            "ms (torch.profiler); launches "
            f"{ {k: r['launches'][k] for k in ('knn', 'mesh_query', 'interp_mxu', 'row_gather')} }"
            + (f"; against G = 1: coarse outputs at most "
               f"{max(r['of_bound'][k] for k in COARSE_KEYS):.3g} of rtol "
               f"{FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it on "
               f"{max(r['share_outside'].values()):.3%} of their elements, "
               f"largest difference "
               f"{max(r['max_abs_err'].values()):.3g}"
               if "of_bound" in r else ""))
    say("phase 3i bench serve: " + json.dumps(tg["bench_serve"]))
    say("phase 3i bench train: " + json.dumps(tg["bench_train"]))

    # ---- phase 3c ----
    with torch.no_grad():
        soa = phase_soa_serving(model, batches[0], dev)
    say("phase 3c SoA serving, far tier on, in turns: full image "
        + "; ".join(f"{n} {' / '.join(f'{t:.1f}' for t in r['frame_ms'])}"
                    for n, r in soa.items())
        + " ms per frame; mode 1 / mode 2 against mode 0: max abs err "
        f"{soa['mode1']['max_abs_err']:.3g} / {soa['mode2']['max_abs_err']:.3g}"
        f" (every output equal); launches mode 0 "
        f"{ {k: soa['mode0']['launches'][k] for k in ('knn', 'mesh_query')} }"
        f", mode 1 "
        f"{ {k: soa['mode1']['launches'][k] for k in ('knn_T', 'mesh_query_T')} }")

    # ---- phase 3e ----
    with torch.no_grad():
        cull = phase_knn_cull_serving(model, batches[0], dev)
    say("phase 3e VANERF_KNN_CULL serving, in turns: full image "
        + "; ".join(f"{n} {' / '.join(f'{t:.1f}' for t in cull[n]['frame_ms'])}"
                    for n in ("default", "cull", "soa2d_cull"))
        + " ms per frame; every output of the culled frames equal to the "
        "same layout's frame without the switch; the 2-D tiled frame "
        "against the default frame: max abs diff "
        f"{cull['soa2d']['max_abs_diff_from_default']:.3g} (other far "
        f"tiles); launches cull "
        f"{ {k: cull['cull']['launches'][k] for k in ('knn_culled', 'knn')} }"
        f", soa2d_cull "
        f"{ {k: cull['soa2d_cull']['launches'][k] for k in ('knn_T_culled', 'knn_T')} }"
        "; kernel 9's (tile, chunk) visit share over a frame's passes, mean "
        "[min, max]: "
        + ", ".join(f"{n} {v['mean']:.5f} [{v['min']:.5f}, {v['max']:.5f}]"
                    for n, v in ((n, cull[n]["visit_share"])
                                 for n in ("cull", "soa2d_cull"))))

    # ---- phase 3f ----
    with torch.no_grad():
        tiers = phase_tier_serving(model, batches[0], frames[0], dev)
    say("phase 3f serving tiers, in turns: full image "
        + "; ".join(
            f"{n} {TIER_CONFIGS[n] or ''} "
            f"{' / '.join(f'{t:.1f}' for t in tiers[n]['frame_ms'])} ms, "
            f"PSNR against the default frame "
            f"{tiers[n]['psnr_vs_default']:.2f} dB" for n in TIER_CONFIGS)
        + f"; VANERF_FAR_SKIP=1: coarse outputs at most "
        f"{max(tiers['skip1']['of_bound'][k] for k in COARSE_KEYS):.3g} of "
        f"rtol {FUSED_RTOL} atol {FUSED_ATOL}, fine outputs outside it on at "
        f"most {max(tiers['skip1']['share_outside'].values()):.3%} of their "
        f"elements and at most "
        f"{max(tiers['pinned']['skip1'].values()):.3g} of it with the fine "
        f"depths pinned; half budgets card vs CPU (8x8 rays) max abs err "
        + ", ".join(f"{n} {max(tiers[n]['card_vs_cpu'].values()):.2e}"
                    f" ({tiers[n]['flipped_rays']} rays with a certified "
                    "merge flip)" for n in ("skip.5", "net.5", "tnet.5")))

    # ---- phase 3d ----
    with torch.no_grad():
        api = phase_mesh_api(model, batches[0], dev)
    say("phase 3d exact mesh API against the renderer's query (far tier "
        f"off), 262,144 points, {api['point_mesh_sdf']['inside_share']:.4f} "
        "of them inside: "
        + "; ".join(f"{k} |sdf| rel err {v['sdf_rel_err']:.2e}"
                    + (f", visibility agrees on {v['qvis_agree']:.4f}"
                       if "qvis_agree" in v else "")
                    + (f", {v['ms']:.2f} ms a call" if "ms" in v else "")
                    for k, v in api.items() if k != "launches")
        + f"; signs differing on "
        f"{max(v['signs_differ'] for k, v in api.items() if k != 'launches')}"
        f" points at most (grazes of the crossing ray); launches "
        f"{ {k: api['launches'][k] for k in ('mesh_query_brute', 'mesh_query_vis_brute')} }")

    # ---- phase 4 ----
    with torch.no_grad():
        errs = phase_card_vs_cpu(model, frames[0], dev)
    say(f"phase 4 card vs CPU (16x16 rays, 64+64 samples): max abs err "
        f"{errs}")

    # ---- phase 5 ----
    train = phase_train(model, batches[0], cfg, dev)
    say(f"phase 5 training ({TRAIN_STEPS} faithful GAN steps, 64x64 rays, "
        f"64+64 samples): {train['ms_per_step']:.1f} ms/step (steps 2-"
        f"{TRAIN_STEPS}; all: {[round(t, 1) for t in train['step_ms']]}); "
        f"peak {train['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{train['launches']}; g_loss "
        f"{[round(lg['train/g_loss'], 4) for lg in train['logs']]}, d_loss "
        f"{[round(lg['train/d_loss'], 4) for lg in train['logs']]}")

    # ---- phase 5b ----
    ftrain = phase_train(model, batches[0], cfg, dev, fused_level=2)
    g0 = train["logs"][0]["train/g_loss"]
    g1 = ftrain["logs"][0]["train/g_loss"]
    ftrain["g_loss_rel_err"] = abs(g1 - g0) / abs(g0)
    check(ftrain["g_loss_rel_err"] <= FUSED_TRAIN_LOSS_RTOL,
          f"VANERF_FUSED_TRAIN=2 G loss {g1} against unfused {g0}")
    say(f"phase 5b training under VANERF_FUSED_TRAIN=2: "
        f"{ftrain['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}; all: "
        f"{[round(t, 1) for t in ftrain['step_ms']]}); peak "
        f"{ftrain['peak_bytes'] / 2**30:.2f} GiB; first-step g_loss {g1:.6g} "
        f"against unfused {g0:.6g} (rel {ftrain['g_loss_rel_err']:.2e}); "
        f"launches {ftrain['launches']}")

    # ---- phase 5c ----
    strain = phase_train(model, batches[0], cfg, dev, soa=1, steps=1)
    g2 = strain["logs"][0]["train/g_loss"]
    strain["g_loss_rel_err"] = abs(g2 - g0) / abs(g0)
    check(strain["g_loss_rel_err"] <= SOA_TRAIN_LOSS_RTOL,
          f"VANERF_SOA_POINTS=1 G loss {g2!r} against mode 0's {g0!r}")
    say(f"phase 5c one GAN step under VANERF_SOA_POINTS=1: g_loss {g2:.9g} "
        f"against mode 0's first step's {g0:.9g} (rel "
        f"{strain['g_loss_rel_err']:.2e}); {strain['step_ms'][0]:.1f} "
        f"ms; launches "
        f"{ {k: strain['launches'][k] for k in ('knn_T', 'mesh_query_T', 'knn', 'mesh_query')} }")

    # ---- phase 5d ----
    turns = phase_train_bf16_turns(model, model16, batches[0], cfg, dev)
    t16, t32 = turns["bfloat16"], turns["float32"]
    say(f"phase 5d bfloat16 training ({TRAIN_STEPS} faithful GAN steps in "
        f"turns with {TRAIN_STEPS} float32 steps): bfloat16 "
        f"{t16['ms_per_step']:.1f} ms/step, float32 "
        f"{t32['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}; all: "
        f"{[round(t, 1) for t in t16['step_ms']]} / "
        f"{[round(t, 1) for t in t32['step_ms']]}); peak "
        f"{t16['peak_bytes'] / 2**30:.2f} / {t32['peak_bytes'] / 2**30:.2f} "
        f"GiB; g_loss {[round(lg['train/g_loss'], 4) for lg in t16['logs']]}"
        f" / {[round(lg['train/g_loss'], 4) for lg in t32['logs']]}; "
        f"bfloat16 launches "
        f"{ {k: v for k, v in t16['launches'].items() if v} } (the float32 "
        f"onehot_scatter {t16['launches']['onehot_scatter']}: every table "
        "with a gradient is bfloat16); the native gather's backward from a "
        f"bfloat16 table, 300 ones into one row: "
        f"{native_gather_accumulation(dev)}")

    # ---- phase 5e ----
    ftrain16 = {}
    g16 = t16["logs"][0]["train/g_loss"]
    for level in (2, 1):
        r = ftrain16[level] = phase_train(model16, batches[0], cfg, dev,
                                          fused_level=level)
        g = r["logs"][0]["train/g_loss"]
        r["g_loss_rel_err"] = abs(g - g16) / abs(g16)
        check(r["g_loss_rel_err"] <= FUSED_TRAIN_LOSS_RTOL,
              f"bfloat16 VANERF_FUSED_TRAIN={level} G loss {g} against "
              f"unfused {g16}")
        kern = ("fused_query_mlp_bf16" if level == 2
                else "fused_geo_mlp_bf16")
        check(r["launches"]["interp_mxu_bf16"] > 0,
              f"bfloat16 VANERF_FUSED_TRAIN={level}: kernel D did not run "
              "in the renders without a graph")
        say(f"phase 5e bfloat16 training under VANERF_FUSED_TRAIN={level}: "
            f"{r['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}; all: "
            f"{[round(t, 1) for t in r['step_ms']]}); peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; first-step g_loss {g:.6g} "
            f"against unfused bfloat16 {g16:.6g} (rel "
            f"{r['g_loss_rel_err']:.2e}, bound {FUSED_TRAIN_LOSS_RTOL}); "
            f"launches {kern} {r['launches'][kern]}, interp_mxu_bf16 "
            f"{r['launches']['interp_mxu_bf16']}, row_gather_bf16 "
            f"{r['launches']['row_gather_bf16']}, onehot_scatter_bf16 "
            f"{r['launches']['onehot_scatter_bf16']}")

    # ---- phase 6 ----
    vs_cpu, g_cpu32 = phase_train_card_vs_cpu(model, frames[0], cfg, dev)
    say(f"phase 6 G-loss gradient card vs CPU (16x16 rays, 64+64 samples): "
        f"loss {vs_cpu['loss_card']:.7g} / {vs_cpu['loss_cpu']:.7g} (rel "
        f"{vs_cpu['loss_rel_err']:.2e}); gradients within "
        f"{vs_cpu['worst_of_bound']:.2f} of their bound at worst "
        f"({vs_cpu['worst_grad']}); largest relative norm error "
        f"{vs_cpu['worst_grad_rel_err']:.2e} ({vs_cpu['worst_rel_grad']})")
    vs_cpu16 = phase_train_card_vs_cpu_bf16(model, model16, frames[0], cfg,
                                            dev, g_cpu32)
    say(f"phase 6 bfloat16 G-loss gradient card vs CPU (16x16 rays, both "
        f"from the CPU's encode): loss {vs_cpu16['loss_card']:.7g} / "
        f"{vs_cpu16['loss_cpu']:.7g} (rel {vs_cpu16['loss_rel_err']:.2e}); "
        f"{vs_cpu16['tensors']} tensors, the worst "
        f"({vs_cpu16['worst_grad']}) at {vs_cpu16['worst_of_bound']:.3f} of "
        f"S / 2 + 2 E ({vs_cpu16['worst_of_S']:.3f} S); the card's float32 "
        f"gradients at {vs_cpu16['control_of_bound']:.2f} of that bound")

    # ---- phase 5f: train-step determinism ----
    rep = phase_train_repeat({"float32": model, "bfloat16": model16},
                             batches[0], cfg, dev)
    def bisect(r):
        return (f"first leaf output differing {r['first_output_differing']}"
                f", first gradient differing (backward order) "
                f"{r['first_gradient_differing']}, optimizer gradients "
                f"differing G {r['grads_differ']['G'][:4]} "
                f"({len(r['grads_differ']['G'])}), D "
                f"{r['grads_differ']['D'][:4]} "
                f"({len(r['grads_differ']['D'])})")

    for cdt, r in rep.items():
        p, u = r["pinned"], r["unpinned"]
        say(f"phase 5f {cdt}: two GAN steps from one state and one seed of "
            f"draws: {'equal to the bit' if p['bit_equal'] else 'DIFFER'} "
            f"(logs differing {p['logs_differ']}, "
            f"{len(p['params_differ'])} of {p['n_params']} parameters"
            + ("" if p["bit_equal"] else f"; {bisect(p)}") + "); "
            f"without the cuDNN pin and with torch's replication pads and "
            f"adaptive pools "
            f"{'equal to the bit' if u['bit_equal'] else 'they differ'} "
            f"({len(u['params_differ'])} parameters; {bisect(u)}); ops "
            f"torch flags as without a deterministic implementation: "
            f"{r['flagged_ops']}; ms/step in turns, median of steps 2-"
            f"{REPEAT_ROUNDS}: pinned {r['median_ms_pinned']:.1f} "
            f"{[round(t, 1) for t in r['ms_pinned']]}, unpinned "
            f"{r['median_ms_unpinned']:.1f} "
            f"{[round(t, 1) for t in r['ms_unpinned']]}")
    for cdt, r in rep.items():
        check(r["pinned"]["bit_equal"] and not r["flagged_ops"],
              f"{cdt} train step does not repeat to the bit")

    # ---- phase 7: the entry point ----
    t0 = time.perf_counter()
    entry = phase_entry_point(dev)
    entry["phase_s"] = time.perf_counter() - t0
    say(f"phase 7 entry point (vanerf_tpu_torch.train.main, full width, "
        f"256^2 subdiv 3, one frame x 8 cameras): --fast_dev_run one step "
        f"({entry['fast_dev_run_s']:.1f} s the invocation); one epoch of "
        f"fit, {entry['steps']} steps, val_fn at steps {entry['val_steps']} "
        f"({' / '.join(f'{t * 1e3:.0f}' for t in entry['val_s'])} ms), the "
        f"steps' launches {entry['train_launches']} (validation's "
        f"{ {k: v for k, v in entry['val_launches'].items() if v} }, the "
        f"training dataset's "
        f"{ {k: v for k, v in entry['data_launches'].items() if v} }); fit "
        f"{entry['fit_ms_per_step']:.1f} ms/step with loading and logging "
        f"(the epoch {entry['epoch_s']:.2f} s less validation), its steps "
        f"on the card's clock {entry['step_ms_in_fit_mean']:.1f} ms/step "
        f"({[round(t, 1) for t in entry['step_ms_in_fit']]}; events, no "
        f"synchronization), the bare "
        f"step {train['ms_per_step']:.1f} ms/step (phase 5); the second "
        f"invocation resumed at step {entry['resumed_step']}, its state "
        f"equal to the bit to the saved one; --run_val on that checkpoint: "
        f"{entry['frames']} frames, run_test {entry['run_test_ms_per_frame']:.1f}"
        f" ms/frame ({entry['render_ms_per_frame']:.1f} ms the render), "
        f"psnr {entry['report']['psnr']}, ssim {entry['report']['ssim']}, "
        f"lpips_pretrained {entry['report']['lpips_pretrained']}; the phase "
        f"{entry['phase_s']:.1f} s")

    # ---- phase 8: the free-viewpoint video ----
    t0 = time.perf_counter()
    video = phase_video(model, dev)
    video["phase_s"] = time.perf_counter() - t0
    fl, patch = video["frame_launches"], video["patch"]
    say(f"phase 8 video (vanerf_tpu_torch.render_dynamic.main, full width, "
        f"256^2 subdiv 3, {VIDEO_FRAMES} orbit frames at level "
        f"{video['level']}, tile_group {video['tile_group']}): "
        f"{video['first_ms']:.1f} ms the first frame, "
        f"{video['rest_median_ms']:.1f} ms the median of the rest "
        f"({min(video['frame_ms'][1:]):.1f}-"
        f"{max(video['frame_ms'][1:]):.1f}); one profiled frame "
        f"{video['frame0_profile']['device_ops']} device ops, busy "
        f"{video['frame0_profile']['device_busy_ms']:.1f} ms; peak "
        f"{video['peak_bytes'] / 2 ** 30:.2f} GiB; launches a frame A "
        f"{fl['mesh_query']:g}, B {fl['knn']:g}, C {fl['rasterize']:g}, D "
        f"{fl['interp_mxu']:g}, 10 {fl['row_gather']:g} (the dataset's "
        f"{ {k: v for k, v in video['data_launches'].items() if v} }); "
        f"alpha_fine max by frame {min(video['alpha_max']):.3f}-"
        f"{max(video['alpha_max']):.3f}; host ms a frame PNG "
        f"{video['encoders']['png_ms']:.1f}, JPEG "
        f"{video['encoders']['jpeg_ms']:.1f}, GIF "
        f"{video['encoders']['gif_ms']:.1f}; 20 PNGs read back equal, "
        f"nvs.mp4 20 JPEG samples ({video['mp4_bytes']} bytes), nvs.gif 20 "
        f"images ({video['gif_bytes']} bytes); camera 0 again equal to the "
        f"bit; its 8x8-ray patch card vs CPU "
        f"{ {k: f'{v:.2g}' for k, v in patch['max_abs_err'].items()} }"
        f" ({patch['ties']['differ']} certified visibility ties "
        f"taken from the card); main {video['main_s']:.1f} s, the phase "
        f"{video['phase_s']:.1f} s")

    # ---- phase 9: two source views ----
    views = run_phase_views(model, batches[0], cfg, dev)

    # ---- phase 10: the preprocessor's device work, the config variants ----
    variants = run_phase_variants(model, model16, batches[0], frames[0], cfg,
                                  dev, train)

    # ---- phase 11: sp_conv at full width ----
    sp = run_phase_sp(model, batches[0], frames[0], cfg, dev)

    # ---- phase 12: data parallelism on the one card ----
    par = run_phase_mesh(model, batches[0], batch_np, cfg, dev)

    launches = dict(
        main["launches"],
        knn_T=soa["mode1"]["launches"]["knn_T"],
        mesh_query_T=soa["mode1"]["launches"]["mesh_query_T"],
        knn_culled=cull["cull"]["launches"]["knn_culled"],
        knn_T_culled=cull["soa2d_cull"]["launches"]["knn_T_culled"],
        mesh_query_brute=api["launches"]["mesh_query_brute"],
        mesh_query_vis_brute=api["launches"]["mesh_query_vis_brute"],
        onehot_scatter=train["launches"]["onehot_scatter"],
        fused_query_mlp=fused["level2"]["launches"]["fused_query_mlp"],
        fused_geo_mlp=fused["level1"]["launches"]["fused_geo_mlp"],
        interp_mxu_bf16=bf16["unfused"]["launches"]["interp_mxu_bf16"],
        row_gather_bf16=bf16["unfused"]["launches"]["row_gather_bf16"],
        fused_query_mlp_bf16=bf16["level2"]["launches"]
        ["fused_query_mlp_bf16"],
        fused_geo_mlp_bf16=bf16["level1"]["launches"]["fused_geo_mlp_bf16"],
        onehot_scatter_bf16=t16["launches"]["onehot_scatter_bf16"],
        fused_query_mlp_bf16_mma=variants["bf16_other_widths"]["2"]
        ["launches"]["fused_query_mlp_bf16_mma"],
        fused_geo_mlp_bf16_mma=variants["bf16_other_widths"]["1"]
        ["launches"]["fused_geo_mlp_bf16_mma"])
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = kres[name]
        check(launches[name] > 0, f"kernel {name} was launched by no path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if "brute_ms" in r:     # A, 7, 9: the sweep over every pair, in turns
            kernels[-1]["brute_ms"] = r["brute_ms"]
        # A, 7, B, 8, 9, 5, 6, C, D, 13, 11, 12: replayed from a CUDA graph;
        # A, 7, B, 8, 9: the operations at the issue rate of separately
        # rounded f32 operations; A, 7, 5, 6, C: the operations the kernel
        # evaluates at that rate
        for k in ("device_ms", "library_device_ms", "issue_bound_ms",
                  "work_issue_bound_ms", "tensor_bound_ms"):
            if k in r:
                kernels[-1][k] = r[k]
        # B, 8, A, 7, D and 10: one launch over a 16-tile group (phase 3i)
        g16 = tg["kernels"]["g16"].get(name)
        if g16:
            kernels[-1].update(g16_device_ms=g16["batch_device_ms"],
                               g1_device_ms=g16["element_device_ms"],
                               g16_bound_ms=g16["batch_bound_ms"])
        # D and 10 at two views: launches a G = 1 frame and one launch over
        # a 16-tile group's 32 element-views; 13 launches a two-view step
        # (phase 9)
        if name in ("interp_mxu", "row_gather"):
            v16 = views["kernels"]["g16"][name]
            kernels[-1].update(
                views_launches=views["serve"]["frames"][1]["launches"][name],
                views_g16_device_ms=v16["batch_device_ms"],
                views_g16_bound_ms=v16["batch_bound_ms"])
        elif name == "onehot_scatter":
            kernels[-1]["views_launches"] = (
                views["train"]["launches"][name] / VIEW_TRAIN_STEPS)
        # under sp_conv (phase 11): launches a G = 1 frame and a step
        if name in sp["serve"]["frames"][1]["launches"]:
            kernels[-1].update(
                sp_launches=sp["serve"]["frames"][1]["launches"][name],
                sp_step_launches=sp["train"]["launches"][name]
                / TRAIN_STEPS)
    say(f"total: {time.perf_counter() - t_start:.0f} s, the build included")
    say("details: " + json.dumps({"gpu": smi, "build_s": build_s,
                                  "kernels": kres, "main_path": main,
                                  "fused_serving": fused,
                                  "bf16_serving": bf16,
                                  "encode_repeat": enc,
                                  "mxu_interp_serving": mxu,
                                  "soa_serving": soa,
                                  "knn_cull_serving": cull,
                                  "tier_serving": tiers, "mesh_api": api,
                                  "tile_group": tg,
                                  "soa_train": strain,
                                  "card_vs_cpu": errs, "train": train,
                                  "fused_train": ftrain,
                                  "train_card_vs_cpu": vs_cpu,
                                  "bf16_train": turns,
                                  "bf16_fused_train": ftrain16,
                                  "bf16_train_card_vs_cpu": vs_cpu16,
                                  "train_repeat": rep,
                                  "entry_point": entry, "video": video,
                                  "views": views, "variants": variants,
                                  "sp_conv": sp, "mesh": par}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
