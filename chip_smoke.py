#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the quickest
proof that the port still builds, agrees with itself and serves.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
3. checks: each kernel and variant (counters on/off, float32 and one
   bfloat16 case) against its plain PyTorch version on the same inputs, at
   the decode path's shapes and at a ragged small shape.  dwconv outputs
   and all counters must be exact (the fused dwconv in both designs: the
   tiled one twice, bit-identical, and the kept one forced, at the decode
   window and the full [4, 2048, 1792] signal); GEMVs on an exact grid (small-integer
   weights, power-of-two scale) bit-equal; other float32 GEMVs within
   ``|d| <= 1e-4 * max|plain| + 1e-4 * |plain|`` (another summation order
   over up to 3072 rows), bfloat16 within 1e-2 (one bf16 rounding of the
   float32 sum).  The head runs on a 384-row pool, as the engine's, at B =
   4 and 1, in both designs: the split kernel twice, bit-identical and
   bit-equal to its plain version summed in the split's order, and the kept
   one forced; ragged pools with pointers out of range.  The
   conv and host-packed kernels (fused_conv2d, shared_conv2d, gemv_host,
   conv2d_host) run the paper CNN's five layer shapes on a 64x48 image and
   ragged shapes (stride 2, symmetric 4-bit, group 2 with odd C, O = 13,
   bf16, a pool pointer out of range, V = 65536); the fused and shared
   conv in both designs — the staged kernel (its code pre-pass exact, two
   launches bit-identical) and the kept one, forced; the host-packed GEMV
   and conv likewise (the staged kernel twice and the kept one forced, one
   case with offsets of -1, V and 2**31 - 1 mixed in).  The five fused GEMV
   launches (kernels 1 and 8-11) likewise run both designs on every case:
   the split design twice, bit-identical, and the kept one, forced.  The
   paired stacked GEMV runs the paired decode's projections on 24-layer
   segment-major stacks, the paired
   and fused GEMVs the parity probe's and qwen3-0.6b's MLP shapes, the
   host-packed dwconv the single-layer signal's offsets, each with a
   ragged case (odd G with its phantom segment, O = 13, offsets out of
   range; the host-packed dwconv in both designs, the staged one twice);
   the plan GEMV (kernel 11) qwen3-0.6b's gate under phase 10's
   permutation plan, an exact grid with a -1 slot and a reused position,
   and a ragged plan (odd G, n != G*group, O = 13).  The fused GEMV
   (kernel 9) also runs WIDE_GEMV's group-1 down projections (llava's at
   B 32 and deepseek-coder-33b's at B 16 in float32, its B 32 in
   bfloat16; the staged design, the chooser's there) and PREFILL_GEMV's
   768 rows (qwen3-0.6b's gate, where the chooser keeps the split, and its
   down projection at group 1, where it takes the staged design) in both
   its designs: the chooser's twice and the other forced twice (the
   split's cluster grown so that a block's offsets fit), each pair
   bit-identical, the libraries' plans checked against ``kernels.ops``'
   mirrors; and COUNTED_GEMV, its counter launch in both designs, whose
   counts must be equal.  Past the ceilings the launches once
   had and the reference never did (CEILING_*): kernel 9 at 65,537 row
   chunks (B 262,148, the second plane of its split grid; and in its
   staged design, 513 row tiles) and at 230,000 segments of group 1 (each
   block staging its offsets in slabs, in both designs; 0.94 GB of
   float32 tables), kernel 1 at 65,537 row chunks (bfloat16, with its
   counters), kernel 3 at 65,537 row chunks (its blocks walking them) and
   the staged conv over 65,537 8x8 images (its code pre-pass walking
   them), each twice, bit-identical, against its plain version (kernel 3
   and the pre-pass exactly), the split GEMVs' plans checked.  The CRC-32
   kernel, in both chunk-pass
   designs (the banked one and the kept one, forced), must equal
   ``zlib.crc32`` bit for bit on ragged lengths (0, 1, a staging step, a
   lane slice and a chunk +- 1, a few MB aligned and not), a continued
   CRC, ragged ranges, a bfloat16 table and strided layers of phase 7's
   segment-major wz stack shape, each twice (bit-identical);
4. timing: each kernel at its main path's shapes — its device time, the
   plain version's, one PyTorch library call computing the same function,
   and the least time the card could take (the larger of the bytes this
   run's data must move at 3.35 TB/s and the fetch-adds at 67 TFLOP/s
   float32).  Every time is device time from ``torch.profiler`` (a
   profile that misses a launch is taken again, up to three times, then
   the script fails).  ``ms`` is cold: L2 is flushed before every timed
   call, as on the decode path, where a step reads ~1 GB of table rows
   once each; the warm time of back-to-back calls is kept beside it.  The
   conv kernels run each layer of the paper CNN at B = 1, 1024x768 on its
   real input (the fused and shared conv: the staged design, its pre-pass
   and fetch summed; the host-packed GEMV and conv: the staged design;
   each beside the kept design forced and the fetch floor from the SM
   count and ``clocks.max.sm``); their plain versions on a 64x48 crop.
   The host-packed GEMV also runs at phase 10's M = 4 plan shape (the
   split design, the chooser's at decode-size M, beside the kept direct
   and staged designs forced) beside ``matmul``.  The fused
   dwconv runs the decode window (counters on, the engine's) and the full
   [4, 2048, 1792] signal in the tiled design, beside the kept one forced,
   with and without the zero fill of its stats.  The fused GEMVs run every shape a decode step launches
   (kernel 1 at the five projections, kernel 8 at the paired decode's
   five), the split design beside the kept one forced (``direct_ms``), as
   are the head (at B = 4 and B = 1, each beside matmul at its batch) and
   the host-packed dwconv (float32 and bfloat16 tables); kernel 9 also at
   llava's group-1 down projection (B 32, G 14336, O 4096, 3.76 GB of
   float32 tables) in its staged design beside the split forced,
   ``torch.matmul``, its bytes bound and the whole table read once.  The CRC
   kernel runs one full-width layer's bytes (2.39 GB) and the head pool's
   (19.8 GB) in each chunk-pass design, beside the bytes bound and the
   host ``zlib.crc32`` time of the same bytes (the reference's function on
   the host, not a library call: torch has none, so its ``library_ms`` is
   null);
5. serving: ``Engine(mamba2-130m full width and depth, slots=4,
   pcilt=True)`` with float32 tables converts (calibrate, build, CRC
   record and verify at load, both on the card) and serves 4 requests of
   8 new tokens under its ``HealthMonitor`` (one layer's CRC a tick, the
   head's on tick 0); prints conversion seconds, table bytes, the head
   pool's bytes, peak memory with the checkpoint ring, step time,
   tokens/s, the monitor's seconds a tick and a head check and its CRC
   launches (counted apart), and the launches per step of each kernel
   (must be 144 / 24 / 1, every fused GEMV and head launch through its
   split design, every dwconv through its tiled one; no health event, no
   rollback); the CRC kernel against ``zlib.crc32`` on layer 0 of every
   real stack and on the head pool and pointers; then checks
   one decode step's logits against the dense fake-quant oracle (every
   layer and the head demoted, so no kernel runs on the oracle's side),
   and times one B = 4 step with its device time and device launches, in
   the split design and with the kept GEMV design forced, then with the
   counters on (as the engine's sentinel runs it) in the tiled dwconv
   design and with the kept one forced (24 more launches a step: its stats
   fills); and one ``MambaLM.prefill`` cache of a 16-token prompt at B =
   4 through the PCILT step, against the same oracle;
6. the paper CNN (``configs/paper_cnn.config()``: 50-80-120-200-350
   channels, 5x5, INT8) on one seeded 1024x768 image: tables built on the
   card (2.57 GiB float32), a 256x192 forward timed and extrapolated
   first, then ``forward(mode="fused")`` (5 fused_conv2d launches), the
   extension-3 network of ``convert_conv_kernel(shared=True,
   weight_bits=4)`` layers (5 shared_conv2d launches) and, on a 256x192
   image, ``forward(mode="kernel")`` (5 gemv_host launches, staged); per-layer
   device ms and design (staged or kept), forward ms, images/s, table
   bytes and peak memory; each
   layer against ``F.conv2d`` on its fake-quantized input, and each
   path's logits against direct multiplication (rtol = atol = 1e-3,
   argmax equal), with the codes flipped between the two chains;
7. the paired (TL1) decode at full width and depth: mamba2-130m with
   ``PCILTConfig(act_bits=2, group=2)``, float32 segment-major stacks
   (21.5 GiB) and the shared-pool head, built by
   ``convert_mamba_decode(paired=True)`` and served by
   ``Engine(pcilt_bundle=...)`` (4 requests of 8 new tokens, sentinel on,
   under its monitor, whose layer checks cross the segment-major strides;
   144 / 24 / 1 launches of the paired stacked GEMV, the dwconv and the
   head per step, every fused GEMV and head launch through its split
   design; no health event; a strided layer of the real stacks against
   ``zlib.crc32``); conversion
   seconds, table bytes, peak memory, the oracle check of phase 5, and the
   median of three B = 4 steps dense, unpaired (kernel 1) and paired
   (kernel 8) with each step's device time, the PCILT steps again with the
   kept fused GEMV design forced;
8. the exact-grid paired parity probe: ``pcilt_linear(path="fused")`` on
   ``[G, V, O]`` and ``pcilt_linear(paired=True, path="fused")`` on
   ``[G2, V2, O]`` bit-equal at ``[4, 64] -> 128`` and ``[4, 768] ->
   1536``;
9. single layers at full published widths: ``convert_kernel`` ->
   ``PCILTLinear(path="fused")`` on qwen3-0.6b's MLP (1024 -> 3072 ->
   1024, 4-bit, group 2; 1.61 GB of float32 tables per projection) at B =
   4 (kernel 9's split design) and over a 4 x 192-token prefill (768
   rows: the gate and up projections on the split, the down projection
   converted at group 1 on the staged design), against the dense product
   on the quantized grid, and ``convert_dwconv`` ->
   ``PCILTDwConv1d(path="kernel")`` on mamba2-130m's conv frontend (C 1792,
   k 4, 2-bit) over a [4, 2048, 1792] signal against the fused path and
   its plain version, through kernel 12's staged design; one mamba2-130m
   layer's ``mamba_block(pcilt=)`` on a [4, 2048, 768] input with 4-bit
   conv tables (C 1792, V 65536): the whole signal through kernel 2
   (CAUSAL, one launch, seen in a profile), exact against its plain
   version on the block's conv input, the conv within 1e-4 and the block
   within one bfloat16 step of the dense fake-quant conv;
10. the paper's extensions 1-3 at qwen3-0.6b's gate width (1024 -> 3072,
    4-bit, group 2, float32 tables, one set at a time): three generalized
    SegmentPlans (``perm``, a seeded permutation into 512 non-adjacent
    pairs; ``pruned``, the 895 largest-norm positions with one -1 slot, G
    448; ``reuse``, the contiguous plan plus 64 segments repeating the 128
    largest-norm positions, G 576) through ``pcilt_linear(plan=,
    path="fused")`` (kernel 11) against its plain version, ``path="kernel"``
    and the dense oracle (1e-4 of the largest output), ``perm`` bit-equal
    to kernel 9 on ``x[:, perm]``, an exact-grid plan probe bit-equal
    across the three; ``log_mul_fn`` tables (extension 2) through kernel 9
    against the gather path and the direct sum; scalar ``SharedTables`` of
    the 4-bit-quantized gate (extension 3) through ``path="shared"``
    (kernel 3 at group 1, its split design) against ``materialize()`` and
    the dense product;
11. learnable tables (extension 4): ``launch.learnable_pcilt.run()``, every
    granularity's loss falling and finite and within 1e-4 of the same run
    on the CPU, each trained table served through kernel 6 equal to the
    gather path;
12. the serving resilience contracts at full width (d 768, vocab 50288)
    with the depth cut to 4 layers (each contract holds a faulted and a
    fault-free engine: 2 x ~29 GB, where full depth would take 2 x ~72
    GiB): ``run_cli`` with ``--chaos``, ``--chaos-drift`` and ``--chaos
    --traffic poisson``, each printing its "contract verified" line;
13. the dense transformer family at qwen3-0.6b's published width and
    depth (28 layers, d 1024, 16 heads over 8 KV heads, vocab 151936;
    seeded weights, bfloat16 compute and KV cache): ``Engine(slots=4,
    max_len=256)`` serves 4 requests of 8 new tokens (set-up seconds,
    median step, tokens/s, peak memory, one B = 4 step's device time and
    busy share; every request served, no restart, no PCILT kernel);
    ``make_prefill_step`` on a 192-token prompt against a decode replay of
    it (2e-2 of the largest logit, argmax equal); a 4096-token prefill
    (the chunked attention path), timed, with ``_sdpa_chunked`` against
    ``_sdpa_dense`` on layer 0 (2e-2 of the largest output);
    ``launch.serve_pcilt.run`` at this width (layer 0's MLP, its fetch
    paths against the dense product; kernel 6's split design at M = 4,
    timed beside its kept direct and staged designs and ``matmul`` by CUDA
    events behind two L2 flushes: late in a run the profiler loses
    records); ``launch.decode_pcilt.run`` through kernels 1
    and 2 and its oracle check, its tokens equal to the CPU run's;
14. training (``launch.train.run``, AdamW, the seeded corpus, the
    ``Supervisor``): qwen3-0.6b ``--full`` at full width and depth for 6
    steps (set-up, median step, tokens/s, one step's device time and
    launches, peak memory, each loss; its state's save and restore is
    phase 23's, on a mesh); mamba2-130m at full width and depth for 5
    steps; the restart contract at full width with the depth cut to 2
    layers (a fault after a checkpoint: restored, ``restarts=1``, and the
    uninterrupted run's state bit for bit); one smoke train step of each
    family on the card against the CPU;
15. qwen1.5-4b, qwen2.5-3b and deepseek-coder-33b at their published
    widths, the depth cut to 4, 4 and 2 layers (seeded weights drawn on
    the card): the ``Engine`` serves 4 requests, a prefill against its
    decode replay (argmax equal or a near-tie), the chunked attention
    against the dense one;
16. the MoE family at granite-moe-3b-a800m's published width and depth
    (32 layers, d 1536, 48 experts top-8; seeded weights drawn on the card
    once, bfloat16 compute): the ``Engine`` serves 4 requests (its step,
    device time and launches, peak memory); a 192-token prefill with the
    entries each layer drops over its capacity; the full width cut to 2
    layers on the card against the CPU (a prefill and 4 steps, 2e-2 of the
    largest logit); ``launch.train.run`` from the same weights at the
    deepest of ``GRANITE_TRAIN_DEPTHS`` that fits, every loss finite and
    the aux losses printed; one smoke train step card against CPU;
17. the hybrid family at zamba2-7b's published width and depth (81 Mamba2
    blocks at d 3584, 14 shared-attention applications): ``prefill`` of
    4 x 64 tokens against a decode replay (5e-2), a 4 x 192 prefill and 8
    ``decode_step``s at B = 4 (times, device time, launches, peak; phase
    23's reference), the ``Engine``'s refusal, training cut to 12 layers,
    the smoke step card against CPU;
18. the audio family at whisper-medium's published width and depth (24
    encoder and 24 decoder layers, d 1024, 16 heads, d_ff 4096, vocab
    51865, 1500 seeded stub frames; seeded weights drawn on the card,
    bfloat16 compute): ``prefill`` of 4 x 192 text tokens against a
    decode replay from a 256-slot cache holding the prefill's
    ``cross_kv`` (2e-2), 8 ``decode_step``s at B = 4 (times, device time,
    launches, busy share, peak), a 3072-token prefill through the chunked
    self- and cross-attention against the dense path (2e-2), training at
    full depth (128 text tokens and the frames, batch 8, 4 steps), the
    smoke step card against CPU;
19. the vlm family at llava-next-mistral-7b's published width and depth
    (32 layers, d 4096, 32 heads over 8, d_ff 14336, vocab 32000, window
    4096, 576 seeded stub image embeddings): a prefill of the image and
    191 text tokens copied into a 4096-slot window cache, one decode step
    against the prefill of 192 (2e-2), 8 decode steps at B = 4 from
    ``pos`` 4092 so that the rolling buffer wraps (times, device time,
    launches, peak), the same wrap at 2 layers card against CPU (2e-2),
    training at the deepest depth that fits at seq 1024 (576 image + 448
    text; the depths that ran out of memory logged), the smoke step card
    against CPU;
20. the design cache: ``PCILTMambaDecode.tune(batch=(1, 4))`` on the
    full-width 4-bit and paired decodes and the kernels at PERF.md's
    table shapes (every key's winner and each candidate's microseconds);
    a second process (``chip_smoke.py --autotune-warm FILE``) on the same
    file tunes with zero timing runs and serves the 4-bit engine's tokens
    through the warm cache equal to the heuristic's.  Every phase before
    it dispatches through an empty cache (``REPRO_PCILT_TUNE_CACHE`` under
    ``build/``), so the heuristic's designs run there, as their design
    counts require; phase 5 prints its median step so and the dispatch's
    host cost (a memoised hit against ``gemv_variant``'s ``lru_cache``);
21. tensor-parallel PCILT tables, every shard on this one card
    (``make_decode_mesh(D, devices=[cuda:0] * D)``, D = 2 and 4): the
    full-width paired mamba2-130m bundle converted sharded, its integrity
    record the unsharded bundle's, a B = 4 step within 2e-4 of the largest
    unsharded logit; the 4-bit bundle built straight into 4 shards and
    served by ``Engine(pcilt_bundle=)`` under its monitor (576 / 24 / 1
    launches a step), against the dense oracle, then the ``--chaos``
    plan's table fault flipping one shard (found, its layer demoted, no
    request lost, undegraded tokens unchanged); the paper CNN's conv4 at
    1024x768 through kernels 4 and 5 sharded (``seg_offset``) against the
    unsharded output (1e-4), each kernel at every shard of the 64x48 crop
    in both designs against its plain version; qwen3-0.6b's gate as
    ``PCILTLinear`` on ``path`` fused, kernel and shared, and paired,
    sharded against unsharded.  Each prints per-device table bytes, device
    time and launches beside the unsharded run's (phase 5's for the 4-bit
    step); the sharded conv4 times go into the kernels line
    (``sharded_ms``);
22. the sharding context (``nn.layers.Ctx``), every mesh device this
    card: qwen3-0.6b at full width and depth placed by ``Engine(cfg, 256,
    4, mesh)`` on (1, 2), (1, 4) and (2, 2) and served on (2, 2) with the
    unsharded engine's tokens, the bytes a device holds of the parameters
    and the cache and
    the leaves the fallback replicates, a decode step and a 192-token
    prefill on each mesh and a kvshard decode (``{"cache_seq": "model"}``)
    at (1, 4) against the unsharded steps (1e-2 of the largest logit), the
    paired mamba2-130m engine on (1, 4) against the unsharded one (tokens,
    2e-4 on one step), ``pipeline_apply`` over 4 stages of 7 blocks; each
    step's host ms, device ms and device launches;
23. the Mamba-based families and training on a mesh, every mesh device
    this card: zamba2-7b at full width and depth on (1, 2) and (1, 4)
    from phase 17's weights and prompt, a 192-token prefill and 8 decode
    steps fed phase 17's tokens, each step's logits against phase 17's
    unsharded ones (``ZAMBA_MESH_TOL``, the argmax equal or a near-tie),
    bytes a device and each step's host ms, device ms and launches beside
    phase 17's; mamba2-130m's paired conversion
    ``convert_mamba_decode(ctx=)`` on parameters placed on (1, 4) against
    the unsharded conversion (the scales' distance in ulps, the records, a
    step within 2e-4, its counters equal); one layer's full-sequence
    ``mamba_block(pcilt=, ctx=)`` on (1, 4) at full width, kernel 2 once
    a channel shard, each launch exact against its plain version (its time
    goes into the kernels line: ``mesh_shard_us``); training on meshes
    (qwen3-0.6b ``--full`` on (2, 2), mamba2-130m on (1, 2), zamba2-7b at
    ``ZAMBA_TRAIN_LAYERS`` on (1, 2)) against the unsharded runs' first
    losses (1e-2), one ``explicit_rs`` step against the default one, and
    the (2, 2) state saved and restored onto (1, 4) by
    ``restore(shardings=)``, bit-equal;
24. expert parallelism (``nn.moe``'s all-to-all and psum schedules),
    every mesh device this card: granite-moe-3b-a800m at full width and
    depth from phase 16's weights placed by ``Engine(cfg, 256, 4, mesh)``
    on (1, 2), (1, 4) and (2, 2) and served on (2, 2) (bytes a device,
    checked by the engine; a B = 4 step's host ms, device ms and launches
    beside phase 16's);
    on each mesh a 4 x 192 prefill (all-to-all) and one decode step from
    its cache (psum) of the drop-free config against the unsharded steps
    (1e-2 of the largest logit), and at the published capacity factor
    the dropped entries per layer and shard beside the unsharded count;
    granite training (drop-free) on (2, 2) and (1, 2) at the deepest of
    ``EP_TRAIN_DEPTHS`` that fits, each loss within 1e-2 of the unsharded
    run's; llama4-maverick's smoke config on (1, 2) and (2, 2) on the card
    against the same mesh on the CPU, and its full width's bytes a device
    on (1, 4) reckoned from the specs; ``optim.compressed_pmean`` over a
    (4,) ``"data"`` mesh of 64 Mi float32 values a shard, each scheme
    against the exact mean (int8 3e-2, bf16 1e-2, none 1e-6), its ms and
    counted bytes;
25. the dry run (``launch.dryrun``): (a) the production cells of
    ``DRYRUN_CELLS`` laid out on meta tensors over the 256- and
    512-coordinate production meshes, each ``python -m
    repro_torch.launch.dryrun`` in a process of its own started at the
    script's start (they need no card; at most ``DRYRUN_WORKERS`` at a
    time, niced; four at two cut depths carried to the full depth), each
    ``ok`` (qwen3-0.6b ``long_500k`` ``skipped``) with its memory, flops
    and move bytes a device and its seconds; (b)
    qwen3-0.6b at full width, a B = 4 decode step and a 4 x 192 prefill,
    unsharded and on (1, 2), (1, 4) and (2, 2) meshes of this card: each
    coordinate's argument bytes, flops and move bytes by kind in the meta
    run exactly those of the same step counted on the card, and the
    unsharded prefill's dry-run peak of live bytes beside
    ``torch.cuda.max_memory_allocated()``; (c) the move record of
    ``compressed_pmean`` int8 on phase 24's (4,) mesh equal to its
    ``stats["sent_bytes"]``; (d) the three repairs of the dry run's port
    faults: qwen3-0.6b ``train_4k``'s busiest and least loaded
    coordinate's flops within 1.1x (each row's loss on its own shards) and
    no buffer of 1 GiB (the joined logits chunk was 148.4 GiB),
    ``decode_32k`` within 80 GB a device (the cache written in place), and
    whisper-medium's decode under the reference's ``kvshard`` rules a cell
    of its own (``decode_32k``, the query heads replicated: each shard
    gathers the cross K/V heads of every model shard);
26. the Hopper resource verifier (``python -m repro_torch.analysis
    --passes smem --sweep full --built``): every design ``kernels.ops``
    admits over the full shape sweep, against the built libraries' own
    constants and plans and their ``ptxas`` reports; prints each kernel's
    registers, static and most dynamic shared memory and spills, and
    every finding; an error finding fails the run, nothing is launched;
27. prints the kernels' JSON line, then as the last line
    ``{"ok": true, "device": {...}}``.

Each path's launches are counted from 0 just before it runs.
Details also go to ``chiprun_out/chip_smoke.json``.  Weights are random
(seeded).  A card without room for the ~72 GiB of float32 tables fails
phase 5 with a message; phase 5's tables are freed before phase 6.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 << 20  # > 5x the H100's 50 MB L2
FLUSH_KERNEL = "bitwise_not"  # in the name of the flush's device kernel
PROFILE_PAD_S = 0.02  # host idle time on each side of a profiled window
#: the marker kernel that opens every profiled window (torch.cuda._sleep's
#: spin kernel, a substring of its name), its length in clocks, and how
#: many open a window (late in a run a window can lose its first two
#: records)
PROFILE_MARKER = "spin_kernel"
PROFILE_MARKER_CYCLES = 1000
PROFILE_MARKERS = 3
#: profiled windows, those whose first record (a marker) was lost, and the
#: markers lost in all
PROFILES = {"windows": 0, "first_record_lost": 0, "markers_lost": 0}
REPLACES = {
    "gemv_stacked": "src/repro/kernels/pcilt_fused.py:372",
    "dwconv1d": "src/repro/kernels/pcilt_dwconv1d.py:192",
    "shared_gemv": "src/repro/kernels/pcilt_shared.py:109",
    "fused_conv2d": "src/repro/kernels/pcilt_fused.py:756",
    "shared_conv2d": "src/repro/kernels/pcilt_shared.py:182",
    "gemv_host": "src/repro/kernels/pcilt_gemv.py:75",
    "conv2d_host": "src/repro/kernels/pcilt_conv2d.py:55",
    "gemv_paired_stacked": "src/repro/kernels/pcilt_fused.py:518",
    "fused_gemv": "src/repro/kernels/pcilt_fused.py:138",
    "gemv_paired": "src/repro/kernels/pcilt_fused.py:231",
    "dwconv1d_host": "src/repro/kernels/pcilt_dwconv1d.py:61",
    "gemv_plan": "src/repro/kernels/pcilt_fused.py:636",
    "crc32": "src/repro/core/pcilt.py:634",
}
SOURCES = {
    "gemv_stacked": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "dwconv1d": "src/repro_torch/kernels/csrc/pcilt_dwconv1d.cu",
    "shared_gemv": "src/repro_torch/kernels/csrc/pcilt_shared_gemv.cu",
    "fused_conv2d": "src/repro_torch/kernels/csrc/pcilt_conv2d.cu",
    "shared_conv2d": "src/repro_torch/kernels/csrc/pcilt_conv2d.cu",
    "gemv_host": "src/repro_torch/kernels/csrc/pcilt_gemv.cu",
    "conv2d_host": "src/repro_torch/kernels/csrc/pcilt_gemv.cu",
    "gemv_paired_stacked": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "fused_gemv": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "gemv_paired": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "dwconv1d_host": "src/repro_torch/kernels/csrc/pcilt_dwconv1d.cu",
    "gemv_plan": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "crc32": "src/repro_torch/kernels/csrc/pcilt_crc32.cu",
}
#: device kernel names (a substring of each) in profiles: the fused GEMV's
#: split design and its kept ("direct") one
GEMV_SPLIT_KERNEL = "gemv_split_kernel"
GEMV_DIRECT_KERNEL = "gemv_direct_kernel"
#: kernel 9's staged design (many rows), a source of its own
GEMV_STAGED_KERNEL = "gemv_staged_kernel"
STAGED_SOURCE = "src/repro_torch/kernels/csrc/pcilt_gemv_staged.cu"
#: the tokens a request of phase 9's prefill through the MLP
PREFILL_T = 192
#: kernel 9 at the group-1 down projections whose offsets overflow one
#: block unless the split's cluster grows (phase 3; the first is timed in
#: phase 4): (what, B, G, O, table dtype), 4-bit activations, V 16
WIDE_GEMV = (("llava-next-mistral-7b down", 32, 14336, 4096, "float32"),
             ("deepseek-coder-33b down", 16, 19200, 7168, "float32"),
             ("deepseek-coder-33b down", 32, 19200, 7168, "bfloat16"))
#: kernel 9 at a 4 x 192-token prefill's rows (phase 3, both designs):
#: qwen3-0.6b's gate, 4-bit group 2 (V 256; the chooser keeps the split),
#: and its down projection at group 1 (V 16; the staged design): (what, B,
#: G, group, O, table dtype); and its counter launch in both designs, whose
#: counts must be equal: a bfloat16 group-1 case with a 16-block staged
#: cluster
PREFILL_GEMV = (("qwen3-0.6b gate prefill", 768, 512, 2, 3072, "float32"),
                ("qwen3-0.6b down prefill g1", 768, 3072, 1, 1024,
                 "float32"))
COUNTED_GEMV = ("counters", 64, 1024, 1, 1000, "bfloat16")
#: the shapes past the ceilings the split GEMVs and the conv pre-pass once
#: had and the reference never did (phase 3): B 262,148 rows are 65,537
#: row chunks of 4, two more than a grid's rows of blocks; G 230,000
#: segments at group 1 overflow a 16-block cluster's shared memory (kernel
#: 9 stages them in slabs; 0.94 GB of float32 tables); 65,537 images pass
#: a grid's z
CEILING_ROWS, CEILING_SEGS, CEILING_IMAGES = 262148, 230000, 65537
#: the shared-pool head's split design and its kept one; the host-packed
#: dwconv's staged design and its kept one
SHARED_SPLIT_KERNEL = "shared_split_kernel"
SHARED_DIRECT_KERNEL = "shared_gemv_kernel"
DWCONV_STAGED_KERNEL = "dwconv1d_staged_kernel"
#: the staged conv design's two launches (code pre-pass, fetch), and the
#: kept design's one
STAGED_KERNELS = ("conv2d_codes_kernel", "conv2d_staged_kernel")
DIRECT_KERNEL = "conv2d_kernel"
#: the host-packed GEMV's split design (its one-pass kernel), staged design
#: and kept one; the fused dwconv's tiled design and its kept one
HOST_SPLIT_KERNEL = "gemv_host_split_kernel"
HOST_STAGED_KERNEL = "gemv_host_staged_kernel"
HOST_DIRECT_KERNEL = "gemv_host_kernel"
#: kernel 6's split design in phase 3: its row counts, and its cases (what,
#: G, V, O, table dtype, exact grid): serve_pcilt's gate, the learnable
#: example's tables, a ragged O, bfloat16, an exact grid, V 4096; every
#: case with offsets of -1, V and 2**31 - 1 mixed in
HOST_SPLIT_ROWS = (1, 4, 64, 1023)
HOST_SPLIT_CASES = (
    ("gate G512 V256 O3072", 512, 256, 3072, "float32", False),
    ("learnable G8 V16 O4", 8, 16, 4, "float32", False),
    ("ragged G25 V256 O13", 25, 256, 13, "float32", False),
    ("gate G512 V256 O3072 bf16", 512, 256, 3072, "bfloat16", False),
    ("gate G512 V256 O3072 exact grid", 512, 256, 3072, "float32", True),
    ("large V G64 V4096 O33", 64, 4096, 33, "float32", False))
DWCONV_TILED_KERNEL = "dwconv1d_tiled_kernel"
DWCONV_DIRECT_KERNEL = "dwconv1d_kernel"
#: shared memory / L1 data path of one SM, bytes a clock (the conv fetch
#: floor's rate)
SMEM_BYTES_PER_CLOCK = 128
#: the launch counts of the fused GEMV source's five launches (kernels 1
#: and 8-11)
GEMV_LAUNCHES = ("gemv_stacked", "fused_gemv", "gemv_paired",
                 "gemv_paired_stacked", "gemv_plan")
DWCONV_HOST_KERNEL = "dwconv1d_host_kernel"
B = 4  # decode slots
#: the six projections of one layer at mamba2-130m width: (G, O)
PROJ_SHAPES = {"wz,wx": (384, 1536), "wB,wC": (384, 128), "wdt": (384, 24),
               "wo": (768, 768)}
#: the paired decode (act_bits 2, group 2): pairs G2 and outputs O of each
#: projection, and its layer count (the stride of the segment-major stacks)
PAIRED_SHAPES = {"wz": (192, 1536), "wB,wC": (192, 128), "wdt": (192, 24),
                 "wo": (384, 768)}
N_LAYERS = 24
#: qwen3-0.6b's MLP (src/repro/configs/qwen3_06b.py): d_model, d_ff
QWEN_D, QWEN_FF = 1024, 3072
#: mamba2-130m's conv frontend: channels, taps; the single-layer signal
CONV_C, CONV_K, CONV_T = 1792, 4, 2048
LIB_NOTE = {"gemv_stacked": "torch.matmul(fake_quant(x), W_l)",
            "dwconv1d": "torch.einsum('bkc,kc->bc', fake_quant(win), w)",
            "shared_gemv": "torch.matmul(fake_quant(x), kernel_q)",
            "fused_conv2d": "F.conv2d(fake_quant(xp), w), cuDNN, TF32 off",
            "shared_conv2d": "F.conv2d(fake_quant(xp), w_q), cuDNN, TF32 off",
            "gemv_host": "F.embedding_bag(off + g*V, T.view(G*V, O), "
                         "mode='sum')",
            "conv2d_host": "F.embedding_bag(off + g*V, T.view(G*V, O), "
                           "mode='sum')",
            "gemv_paired_stacked": "torch.matmul(fake_quant(x), W_l)",
            "fused_gemv": "torch.matmul(fake_quant(x), W)",
            "gemv_paired": "torch.matmul(fake_quant(x), W)",
            "dwconv1d_host": "torch.take(T, c*V + off)",
            "gemv_plan": "torch.matmul(fake_quant(x)[:, plan], W[plan])",
            "crc32": "none: torch has no CRC (host_zlib_ms: the reference's "
                     "zlib.crc32 on the host, not a library kernel)"}
#: the CRC kernel's device kernels (a substring of each): the chunk pass
#: (the banked design's and the kept one's) and the combine passes
CRC_KERNELS = ("crc_banked_kernel", "crc_chunks_kernel",
               "crc_combine_kernel")
#: one full-width mamba2-130m layer at 4 bits, group 2, float32, table by
#: table: the conv table [1792, 65536], wz, wx [384, 256, 1536], wB, wC
#: [384, 256, 128], wdt [384, 256, 24], wo [768, 256, 768] (the monitor's
#: layer check CRCs them in one call)
LAYER_TABLES = {"conv": 4 * 1792 * 65536, "wz": 4 * 384 * 256 * 1536,
                "wx": 4 * 384 * 256 * 1536, "wB": 4 * 384 * 256 * 128,
                "wC": 4 * 384 * 256 * 128, "wdt": 4 * 384 * 256 * 24,
                "wo": 4 * 768 * 256 * 768}
LAYER_BYTES = sum(LAYER_TABLES.values())
#: the shared-pool head: [384, 256, 50288] float32
HEAD_POOL_BYTES = 4 * 384 * 256 * 50288
#: the depth of phase 12's engines (full width)
CONTRACT_LAYERS = 4
#: phase 12's late chaos plan: the table faults (the CLI plan's steps 15
#: and 19) moved past the steps where four of the six requests finish, so
#: that those four are served undegraded and held token for token to the
#: fault-free run (tests/test_torch_resilience.py re-keys its plan alike)
LATE_CHAOS_STEPS = {15: 70, 19: 74}
#: the prompt of phase 5's prefill cache and of phase 13's prefill against
#: a decode replay; phase 13's long prompt (S * S >= 2048**2: the chunked
#: attention path)
PREFILL_PROMPT, REPLAY_PROMPT, LONG_PROMPT = 16, 192, 4096
#: phase 13's prefill against a decode replay: the first 64 of its
#: 192-token prompt (the replay's 192 steps took ~15 s; phase 17 replays
#: 64 as well)
DENSE_REPLAY_PROMPT = 64
#: phase 14's restart contract: its depth at full width; phase 15's
#: configs and the depth each is cut to
RESTART_LAYERS = 2
DENSE_CUT_LAYERS = {"qwen1.5-4b": 4, "qwen2.5-3b": 4,
                    "deepseek-coder-33b": 2}
#: phase 16: granite's depth on the card against the CPU, and the depths
#: its training tries, deepest first (AdamW's unfused update holds ~8
#: copies of the parameters and the temporaries of its largest leaf: 16
#: layers ran out of an 80 GB card at step 1); phase 17: zamba2's training
#: depth (2 segments, so both shared sets run) and the tolerance of its
#: prefill against a decode replay (the SSD's bfloat16 operands over 81
#: blocks: the smoke config in bfloat16 differs from the JAX package's by
#: 3.9% of its largest logit on the CPU)
GRANITE_CUT_LAYERS = 2
GRANITE_TRAIN_DEPTHS = (14, 12)
ZAMBA_TRAIN_LAYERS = 12
ZAMBA_REPLAY_TOL = 5e-2
#: phase 18: whisper's long prompt (a 3072 x 3072 self-attention and a
#: 3072 x 1500 cross-attention: both past the chunked path's 2048**2) and
#: its replay cache's slots
WHISPER_LONG_PROMPT = 3072
WHISPER_CACHE = 256
#: phase 19: llava's text after its 576 image tokens (the prefill of the
#: first 191 against the prefill of all 192), the wrap's first position in
#: the 4096-slot window, the depth of the card-against-CPU cut, and the
#: depths its training tries, deepest first, at seq 1024 (576 image + 448
#: text tokens; after phases 3-18, 6 layers fit an 80 GB card at a 67.92
#: GiB peak: the depth that fits moves with what the allocator holds)
LLAVA_TEXT = 192
LLAVA_WRAP_POS = 4092
LLAVA_CUT_LAYERS = 2
LLAVA_TRAIN_DEPTHS = (7, 6, 5)
LLAVA_TRAIN_SEQ = 1024
#: the paper CNN's image (H, W) at full size (printed W x H, as the paper), and the small image of the
#: checks and of the plain versions' timing
FULL_HW = (768, 1024)
SMALL_HW = (48, 64)
#: the host-packed path's image in phase 6: its patches and offsets at full
#: size would take about 31 GB
KERNEL_HW = (192, 256)
#: phase 22: the dense engine's meshes (every device this card), the one
#: that also decodes with a time-sharded KV cache, and the pipeline's
#: stages, microbatches and tokens a microbatch
MESH_SHAPES = ((1, 2), (1, 4), (2, 2))
#: the mesh the engine serves its requests on (every mesh places them, and
#: times and checks a step and a prefill)
MESH_SERVED = (2, 2)
KVSHARD_MESH = (1, 4)
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 4, 64
#: phase 17's replay prompt (the prefill against a decode replay; phase
#: 23's meshes take its 192-token prompt); phase 23: zamba2's serving
#: meshes and their tolerance against phase 17's unsharded logits (bf16
#: compute over 81 blocks: zamba2's own rule, ``ZAMBA_REPLAY_TOL``; the
#: mesh's prefill differs from the unsharded one by ~4 bfloat16 ulps of
#: the largest logit, as much as phase 17's replay does), the mesh of the
#: conversion under a ctx and of the full-sequence PCILT block, the
#: training meshes, their steps and the elastic restore's mesh
ZAMBA_REPLAY_PROMPT = 64
ZAMBA_MESHES = ((1, 2), (1, 4))
ZAMBA_MESH_TOL = ZAMBA_REPLAY_TOL
CONVERT_MESH = (1, 4)
TRAIN_MESHES = {"qwen3-0.6b": (2, 2), "mamba2-130m": (1, 2),
                "zamba2-7b": (1, 2)}
MESH_TRAIN_STEPS = 3
MESH_TRAIN_TOL = 1e-2
ELASTIC_MESH = (1, 4)
#: phase 24: granite's serving meshes, its training meshes (the first
#: finds the depth: the deepest of ``EP_TRAIN_DEPTHS`` that fits), its
#: training steps, llama4's smoke meshes (on the card against the CPU,
#: ``EP_SMOKE_TOL``), and the compressed reduction's shards and values a
#: shard (64 Mi float32 each)
EP_MESHES = ((1, 2), (1, 4), (2, 2))
EP_SERVED = (2, 2)  # the engine serves its requests here (as MESH_SERVED)
EP_TRAIN_MESHES = ((2, 2), (1, 2))
EP_TRAIN_DEPTHS = (12, 8)
EP_TRAIN_STEPS = 3
EP_LLAMA_MESHES = ((1, 2), (2, 2))
EP_SMOKE_TOL = 2e-2
EP_COMPRESS_SHARDS, EP_COMPRESS_N = 4, 64 << 20
#: phase 25: the production cells laid out on meta tensors ((arch, shape,
#: multi_pod), the slowest first; the last must come back skipped), the
#: cells run at two cut depths and carried to the full one
#: (``dryrun.measure_cell``; the flops and moves exact: at full depth the
#: four took 2650 s of host time on 4 processes and slowed the script's
#: own phases 15–40%, PERF.md §7), the dry-run processes at a
#: time, a cell's time limit, and the card's meshes the dry run is held to
#: (qwen3-0.6b, a B = 4 decode step against a cache of ``DRYRUN_CACHE``
#: slots and a 4 x ``DRYRUN_PREFILL`` prefill)
DRYRUN_CELLS = (("llama4-maverick-400b-a17b", "train_4k", True),
                ("granite-moe-3b-a800m", "train_4k", False),
                ("qwen3-0.6b", "train_4k", False),
                ("qwen3-0.6b", "prefill_32k", False),
                ("qwen3-0.6b", "decode_32k", False),
                ("whisper-medium", "decode_32k", False),
                ("mamba2-130m", "long_500k", False),
                ("qwen3-0.6b", "long_500k", False))
DRYRUN_DEPTHS = {("llama4-maverick-400b-a17b", "train_4k", True): (0, 2),
                 ("granite-moe-3b-a800m", "train_4k", False): (0, 1),
                 ("qwen3-0.6b", "train_4k", False): (0, 1),
                 ("qwen3-0.6b", "prefill_32k", False): (1, 2)}
DRYRUN_SKIPPED = {("qwen3-0.6b", "long_500k", False)}
#: cells run under one of ``launch.dryrun.VARIANTS``: whisper-medium's
#: decode under the reference's ``kvshard`` rules
#: (``src/repro/launch/dryrun.py:97``)
DRYRUN_VARIANTS = {("whisper-medium", "decode_32k", False): "kvshard"}
#: the repaired faults' bounds (phase 25 (d)): the busiest coordinate's
#: flops over the least loaded one's at qwen3-0.6b ``train_4k``, the
#: largest buffer there, and a device's bytes at ``decode_32k``
DRYRUN_FLOPS_SKEW, DRYRUN_MAX_BUFFER, DRYRUN_DEVICE_BYTES = 1.1, 2 ** 30, \
    80e9
DRYRUN_WORKERS = 2
#: llama4's cell, the longest, took 895 s of host time in PR 29 (398 s in
#: PR 28, before each row ran its own loss and each query shard its own
#: KV heads); the script reaches phase 25 at ~950 s and waits there
DRYRUN_CELL_TIMEOUT = 1080
DRYRUN_MESHES = ((1, 2), (1, 4), (2, 2))
DRYRUN_CACHE, DRYRUN_PREFILL = 256, 192
#: what phase 17 hands to phase 23 (its unsharded zamba2 run), off the
#: JSON report
_HANDOFF = {}


class SmokeFailure(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------


def _device_times(prof):
    """``{key: (launches, device microseconds)}`` of a profile's rows that
    ran on the device."""
    out = {}
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = getattr(row, "self_cuda_time_total", 0.0)
        if t > 0:
            out[row.key] = (row.count, t)
    return out


def _profile(torch, fn):
    """Device times of ``fn()``.  The window is padded with host idle time
    on both sides, so the device's records lie well inside it (records of
    a short window at its edges can fall outside the window the profiler
    keeps), and its first device activities are ``PROFILE_MARKERS`` marker
    kernels (``torch.cuda._sleep``, left out of the times): from phase 4's
    conv timing on, the profiler drops the first device record of every
    window, and late in a run sometimes the first two, so the markers take
    that loss.  ``PROFILES`` counts the windows, those that lost a marker
    and the markers lost."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    times = _device_times(prof)
    PROFILES["windows"] += 1
    lost = PROFILE_MARKERS - sum(c for k, (c, _) in times.items()
                                 if PROFILE_MARKER in k)
    PROFILES["first_record_lost"] += lost > 0
    PROFILES["markers_lost"] += lost
    return {k: v for k, v in times.items() if PROFILE_MARKER not in k}


class L2Flush:
    """Evicts the L2 cache by inverting a buffer five times its size.  Its
    device kernel (``FLUSH_KERNEL`` in the name) is left out of timings."""

    def __init__(self, torch):
        self.buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.bitwise_not_()


def time_calls(torch, calls, flush, kernel=None, reps=5, warmup=2,
               retries=None, launches_per_call=1):
    """Per-call times (ms) of ``calls`` (zero-argument callables), all
    profiler device time: ``ms``, the mean with L2 flushed before every
    call, and ``warm_ms`` back to back (the named kernels' time, each call
    ``launches_per_call`` launches of them — ``kernel`` is a name or a tuple of
    names; or, for a composite call, every kernel's but the flush's); and
    ``events_ms``, the median over ``reps`` of the wall rate of
    back-to-back calls on the device clock (CUDA events), host overhead
    included.  ``warmup`` calls run first.  A profile that misses a launch
    of the named kernels, or shows no device time, is taken again (counted
    in ``retries``), up to three times; then the script fails."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    for c in calls[:warmup]:
        c()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for c in calls:
            c()
        e.record()
        e.synchronize()
        ev.append(s.elapsed_time(e) / len(calls))

    def run(cold):
        for c in calls:
            if cold:
                flush()
            c()

    per_call = []
    for cold in (True, False):
        for attempt in range(3):
            prof = _profile(torch, lambda: run(cold))
            flushes = [k for k in prof if FLUSH_KERNEL in k]
            require(cold or not flushes,
                    f"the timed calls run the L2 flush's kernel {flushes}")
            mine = [v for k, v in prof.items() if FLUSH_KERNEL not in k
                    and (names is None or any(m in k for m in names))]
            n, us = sum(c for c, _ in mine), sum(t for _, t in mine)
            if us > 0 and (names is None
                           or n == len(calls) * launches_per_call):
                per_call.append(us / 1000.0 / len(calls))
                break
            if retries is not None:
                retries.append({"kernel": kernel, "cold": cold,
                                "launches_seen": n,
                                "of": len(calls) * launches_per_call})
            log(f"  (profile {attempt + 1} saw {n} of "
                f"{len(calls) * launches_per_call} launches"
                f" of {kernel or 'the calls'}, {us:.1f} us: taken again; "
                f"rows {[(k[:48], c) for k, (c, _) in prof.items()]})")
        else:
            raise SmokeFailure(f"the profiler missed launches of "
                               f"{kernel or 'the calls'} three times")
    return {"ms": per_call[0], "warm_ms": per_call[1],
            "events_ms": statistics.median(ev)}


# ----------------------------------------------------------------------------
# phase 3 + 4: kernels against their plain versions, and their times
# ----------------------------------------------------------------------------


def close(torch, got, want, rtol, exact=False):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    mx = float(err.max()) if err.numel() else 0.0
    if exact:
        return mx, bool(torch.equal(got, want))
    bound = rtol * float(want.abs().max()) + rtol * want.abs()
    return mx, bool((err <= bound).all())


def gemv_designs(torch, ops, run):
    """``run()``, one fused GEMV launch, in both designs: the split design
    twice, which must give the same bits, and the kept design forced; the
    variant counts must say which ran.  -> (split result, kept result)."""
    seen = dict(ops.GEMV_VARIANT_LAUNCHES)
    got, again = run(), run()
    with ops._gemv_forced("direct"):
        kept = run()
    torch.cuda.synchronize()
    diff = {v: c - seen[v] for v, c in ops.GEMV_VARIANT_LAUNCHES.items()}
    require(diff == {"split": 2, "staged": 0, "direct": 1},
            f"the fused GEMV designs ran {diff}, not split 2, direct 1")
    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
    require(all(torch.equal(a, b) for a, b in pairs),
            "two launches of the split fused GEMV differ")
    return got, kept


def head_designs(torch, ops, x, pool, idx, spec, scale, group):
    """Kernel 3 in both designs: the split design twice, which must give
    the same bits and equal the plain version summed in the split's order
    (the same float32 adds), and the kept design forced; the variant
    counts must say which ran.  -> (split result, kept result)."""
    seen = dict(ops.SHARED_GEMV_VARIANT_LAUNCHES)
    got = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    again = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    kept = ops._shared_gemv(x, pool, idx, spec, scale, group,
                            variant="direct")
    ordered = ops.shared_gemv_plain(x, pool, idx, spec, scale, group,
                                    split_order=True)
    torch.cuda.synchronize()
    diff = {v: c - seen[v]
            for v, c in ops.SHARED_GEMV_VARIANT_LAUNCHES.items()}
    require(diff == {"split": 2, "direct": 1},
            f"the head's designs ran {diff}, not split 2, direct 1")
    require(torch.equal(got, again), "two launches of the split head differ")
    require(torch.equal(got, ordered), "the split head differs from its "
            "plain version summed in the split's order")
    return got, kept


def dwconv_host_designs(torch, ops, off, tabs):
    """Kernel 12 in both designs: the staged design twice and the kept
    design forced, the variant counts saying which ran.  -> the three
    results."""
    seen = dict(ops.DWCONV_HOST_VARIANT_LAUNCHES)
    runs = (ops.pcilt_dwconv1d(off, tabs), ops.pcilt_dwconv1d(off, tabs),
            ops._dwconv1d_host(off, tabs, variant="direct"))
    torch.cuda.synchronize()
    diff = {v: c - seen[v]
            for v, c in ops.DWCONV_HOST_VARIANT_LAUNCHES.items()}
    require(diff == {"staged": 2, "direct": 1},
            f"the host dwconv's designs ran {diff}, not staged 2, direct 1")
    return runs


def dwconv_designs(torch, ops, run):
    """``run(variant)``, one fused dwconv launch, in both designs: the tiled
    design twice, which must give the same bits (outputs and counters), and
    the kept design forced; the variant counts must say which ran.  -> the
    three results."""
    seen = dict(ops.DWCONV_VARIANT_LAUNCHES)
    runs = (run(None), run(None), run("direct"))
    torch.cuda.synchronize()
    diff = {v: c - seen[v] for v, c in ops.DWCONV_VARIANT_LAUNCHES.items()}
    require(diff == {"tiled": 2, "direct": 1},
            f"the fused dwconv's designs ran {diff}, not tiled 2, direct 1")
    pairs = zip(runs[0], runs[1]) if isinstance(runs[0], tuple) \
        else [(runs[0], runs[1])]
    require(all(torch.equal(a, b) for a, b in pairs),
            "two launches of the tiled dwconv differ")
    return runs


def host_designs(torch, ops, run, chosen="staged", others=()):
    """``run(variant)``, one host-packed GEMV or conv launch: the wrappers'
    choice (``chosen``, the staged or the split design) twice, which must
    give the same bits, the kept design forced and each of ``others``
    forced; the variant counts must say which ran.  -> (chosen result, kept
    result, [the others' results])."""
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    got, again, kept = run(None), run(None), run("direct")
    forced = [run(v) for v in others]
    torch.cuda.synchronize()
    diff = {v: c - seen[v] for v, c in ops.GEMV_HOST_VARIANT_LAUNCHES.items()
            if c != seen[v]}
    want = {chosen: 2, "direct": 1, **dict.fromkeys(others, 1)}
    require(diff == want, f"the host-packed designs ran {diff}, not {want}")
    require(torch.equal(got, again),
            f"two launches of the {chosen} host-packed GEMV differ")
    return got, kept, forced


def kept_design(ops, calls, design="direct"):
    """``calls`` with the kept fused GEMV design (or ``design``) forced."""
    def forced(call):
        with ops._gemv_forced(design):
            return call()
    return [lambda c=c: forced(c) for c in calls]


def check_kernels(torch, ops, core, report):
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(bits=4, symmetric=True)
    group = 2
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in REPLACES}

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * s

    def record(kernel, what, mx, ok, tol):
        errs[kernel] = max(errs[kernel], mx)
        report["checks"].append({"kernel": kernel, "case": what,
                                 "max_abs_err": mx, "tol": tol, "ok": ok})
        log(f"check {kernel:13s} {what:44s} max_abs_err={mx:.3e} "
            f"[{tol}] {'ok' if ok else 'FAIL'}")
        require(ok, f"{kernel} {what}: kernel disagrees with its plain version")

    def x_and_scale(n, rows=B):
        x = randn(rows, n, s=2.0)
        return x, float(scale_from_amax(0.8 * x.abs().max(), spec))

    # -- stacked GEMV: the decode shapes, one bf16 case, exact grid, ragged
    cases = [(f"{k} G{G} O{O}", rows_, G, O, torch.float32, False)
             for k, (G, O) in PROJ_SHAPES.items() for rows_ in (B,)]
    cases += [("wz,wx G384 O1536 bf16", B, 384, 1536, torch.bfloat16, False),
              ("wz,wx G384 O1536 exact grid", B, 384, 1536, torch.float32,
               True),
              ("ragged B3 G5 O130", 3, 5, 130, torch.float32, False),
              ("ragged B1 G7 O24 exact grid", 1, 7, 24, torch.float32, True)]
    for what, rows_, G, O, dt, exact in cases:
        L = 2
        x, scale = x_and_scale(G * group, rows_)
        if exact:
            w = torch.randint(-3, 4, (L, G * group, O), generator=gen,
                              device=dev).float()
            scale = 0.5
        else:
            w = randn(L, G * group, O, s=(G * group) ** -0.5)
        tabs = torch.stack([core.build_grouped_tables(w[l], spec, scale, group)
                            for l in range(L)]).to(dt)
        for stats in (False, True):
            runs = gemv_designs(
                torch, ops, lambda: ops.pcilt_fused_gemv_stacked(
                    x, tabs, 1, spec, scale, group, with_stats=stats))
            want = ops.gemv_stacked_plain(x, tabs, 1, spec, scale, group,
                                          with_stats=stats)
            for design, got in zip(("", " kept design"), runs):
                wnt = want
                if stats:
                    (got, gc, gr), (wnt, wc, wr) = got, want
                    record("gemv_stacked", f"{what}{design} counters", 0.0,
                           int(gc) == int(wc) and float(gr) == float(wr),
                           "count, ratio exact")
                rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
                mx, ok = close(torch, got, wnt, rtol, exact)
                record("gemv_stacked",
                       f"{what}{design} counters={int(stats)}", mx, ok,
                       "exact" if exact else f"rtol {rtol}")
        del tabs, w

    # -- dwconv: decode window [4, 4, 1792] VALID, f32 + bf16, the full
    #    [4, 2048, 1792] signal (2-bit, CAUSAL), ragged CAUSAL; both designs
    #    (the tiled one twice), saturating taps at both ends of the window
    for what, (Bq, T, C), pad, dt, sp in [
            ("window B4 k4 C1792 VALID", (B, 4, 1792), "VALID", torch.float32,
             spec),
            ("window B4 k4 C1792 VALID bf16", (B, 4, 1792), "VALID",
             torch.bfloat16, spec),
            (f"signal B4 T{CONV_T} C{CONV_C} 2-bit CAUSAL",
             (B, CONV_T, CONV_C), "CAUSAL", torch.float32,
             QuantSpec(bits=2, symmetric=True)),
            ("ragged B3 T9 C33 CAUSAL", (3, 9, 33), "CAUSAL", torch.float32,
             spec)]:
        filt = randn(4, C, s=0.5)
        x = randn(Bq, T, C, s=2.0)
        scale = float(scale_from_amax(0.8 * x.abs().max(), sp))
        x[:, 0, ::5] *= 4.0
        x[:, -1, 2::5] *= -4.0
        tabs = core.build_dwconv_tables(filt, sp, scale).to(dt)
        xp = torch.nn.functional.pad(x, (0, 0, 3, 0)) if pad == "CAUSAL" else x
        for stats in (False, True):
            runs = dwconv_designs(torch, ops, lambda v: ops._fused_dwconv1d(
                x, tabs, sp, scale, 4, pad, with_stats=stats, variant=v))
            want = ops.dwconv1d_plain(xp, tabs, sp, scale, 4,
                                      with_stats=stats)
            for design, got in zip(("", " again", " kept design"), runs):
                wnt = want
                if stats:
                    (got, gc, gr), (wnt, wc, wr) = got, want
                    record("dwconv1d", f"{what}{design} counters", 0.0,
                           int(gc) == int(wc) and float(gr) == float(wr),
                           "count, ratio exact")
                mx, ok = close(torch, got, wnt, 0.0, exact=True)
                record("dwconv1d", f"{what}{design} counters={int(stats)}",
                       mx, ok, "exact")
        del tabs

    # -- shared-pool head: [4, 768] x, G = 384, O = 50288 (ragged), the
    #    engine's pool of 384 distinct segments (18.4 GiB in float32), f32 +
    #    bf16 + exact grid, and at B = 1; ragged, with each segment twice
    #    (X = G / 2) and two pointers out of range; both designs
    for what, rows_, G, O, dt, exact, dup in [
            ("head B4 G384 X384 O50288", B, 384, 50288, torch.float32,
             False, False),
            ("head B4 G384 X384 O50288 bf16", B, 384, 50288,
             torch.bfloat16, False, False),
            ("head B4 G384 X384 O50288 exact grid", B, 384, 50288,
             torch.float32, True, False),
            ("head B1 G384 X384 O50288", 1, 384, 50288, torch.float32,
             False, False),
            ("ragged B2 G6 X3 O7, pointers out of range", 2, 6, 7,
             torch.float32, False, True),
            ("ragged B3 G8 X4 O13 bf16, pointers out of range", 3, 8, 13,
             torch.bfloat16, False, True)]:
        x, scale = x_and_scale(G * group, rows_)
        n_blk = (G // 2 if dup else G) * group
        if exact:
            blocks = torch.randint(-3, 4, (n_blk, O), generator=gen,
                                   device=dev).float()
            scale = 0.5
        else:
            blocks = randn(n_blk, O, s=0.05)
        if dup:
            blocks = torch.cat([blocks, blocks])
        shared = core.build_shared_grouped_tables(blocks, spec, scale, group)
        pool, idx = shared.pool.to(dt), shared.seg_idx
        del shared, blocks
        require(pool.shape[0] == (G // 2 if dup else G),
                f"{what}: pool has {pool.shape[0]} rows")
        if dup:
            idx = idx.clone()
            idx[0], idx[-1] = -1, pool.shape[0] + 2
        want = ops.shared_gemv_plain(x, pool, idx, spec, scale, group)
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        for design, got in zip(("", " kept design"), head_designs(
                torch, ops, x, pool, idx, spec, scale, group)):
            mx, ok = close(torch, got, want, rtol, exact)
            record("shared_gemv", what + design, mx, ok,
                   "exact" if exact else f"rtol {rtol}")
        del pool

    # -- a wide head at B = 32: G = 7168 (deepseek-coder-33b's width at
    #    group 1), O = 32256, where the split's cluster doubles to 2 so that
    #    two blocks fit an SM (its __launch_bounds__); 7168 pointers into a
    #    16-row pool; the split design twice, bit-identical and bit-equal to
    #    its plain version summed in the split's order (the kept design
    #    cannot hold 32 x 7168 offsets in a block)
    WB, WG, WO = 32, 7168, 32256
    sp = ops.shared_gemv_variant(WB, WG, WO, 4)
    require(sp.cluster == 2 and ops.SHARED_BLOCKS_PER_SM * (
        ops.shared_gemv_smem_bytes(sp, WG) + ops.BLOCK_RESERVED_SMEM)
        <= ops.SM_SMEM_BYTES, f"the wide head's split {sp} does not keep "
        f"two blocks an SM")
    x, scale = x_and_scale(WG * group, WB)
    pool = randn(16, 1 << (spec.bits * group), WO, s=0.05)
    idx = torch.randint(0, 16, (WG,), generator=gen, device=dev,
                        dtype=torch.int32)
    seen = ops.SHARED_GEMV_VARIANT_LAUNCHES["split"]
    got = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    again = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    ordered = ops.shared_gemv_plain(x, pool, idx, spec, scale, group,
                                    split_order=True)
    torch.cuda.synchronize()
    require(ops.SHARED_GEMV_VARIANT_LAUNCHES["split"] - seen == 2,
            "the wide head did not run the split design twice")
    require(torch.equal(got, again), "two launches of the wide head differ")
    mx, ok = close(torch, got, ordered, 0.0, exact=True)
    record("shared_gemv", f"wide head B{WB} G{WG} X16 O{WO}, cluster 2", mx,
           ok, "exact, the split's order")
    del pool, x, got, again, ordered
    check_conv_kernels(torch, ops, record, gen)
    check_host_split(torch, ops, record, gen)
    check_slice3_kernels(torch, ops, record, gen)
    check_plan_kernel(torch, ops, record, gen)
    check_wide_gemv(torch, ops, record, gen)
    check_ceilings(torch, ops, core, record, gen)
    return errs


def check_wide_gemv(torch, ops, record, gen):
    """Kernel 9 at WIDE_GEMV's group-1 widths (4-bit activations, V 16,
    seeded tables [G, 16, O]: 3.76 GB at llava's float32, 8.81 GB at
    deepseek's; the staged design, the chooser's there) and at
    PREFILL_GEMV's rows, in both its designs: the chooser's twice and the
    other forced twice (the split's cluster grown so that a block's
    offsets fit), each pair bit-identical, each held to the plain version
    at kernel 9's tolerance (the plain gather runs in row chunks), the
    libraries' plans checked against ``kernels.ops``' mirrors at the first
    launch; the kept design cannot hold B x G offsets in a block.  Then
    COUNTED_GEMV: kernel 9's counter launch in both designs, whose counts
    must equal each other's and the plain version's exactly.  Each case is
    freed before the next."""
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    cases = [(what, rows, G, 1, O, dt) for what, rows, G, O, dt in WIDE_GEMV]
    for what, rows, G, group, O, dt in cases + list(PREFILL_GEMV):
        wide = (what, rows, G, group, O, dt) in cases
        dtype = getattr(torch, dt)
        es = torch.empty((), dtype=dtype).element_size()
        V = 1 << (spec.bits * group)
        sp = ops.gemv_variant(rows, G, O, es)
        plan = ops.gemv_staged_plan(rows, G, V, O, es)
        chosen = ops.gemv_fused_variant(rows, G, V, O, es)
        other = "split" if chosen == "staged" else "staged"
        require(ops.gemv_candidates(rows, G, O, es, V) == [chosen, other]
                and (chosen == "staged" or not wide),
                f"{what}: kernel 9 at B {rows}, G {G} does not take the "
                f"staged design first, or a block holds B x G offsets")
        require(not wide or sp.cluster > 1, f"{what}: the split {sp} at B "
                f"{rows}, G {G} does not grow its cluster")
        tabs = (torch.randn(G, V, O, generator=gen, device=dev)
                * (G * group) ** -0.5).to(dtype)
        x = torch.randn(rows, G * group, generator=gen, device=dev) * 2.0
        scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
        want = ops.fused_gemv_plain(x, tabs, spec, scale, group)
        rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        notes = {"staged": f"rows {plan.rows}, cluster {plan.cluster}",
                 "split": f"cluster {sp.cluster}"}
        for design in (chosen, other):
            note = notes[design] + (", chosen" if design == chosen else "")
            seen = dict(ops.GEMV_VARIANT_LAUNCHES)
            force = contextlib.nullcontext() if design == chosen \
                else ops._gemv_forced(design)
            with force:
                got = ops.pcilt_fused_gemv(x, tabs, spec, scale, group)
                again = ops.pcilt_fused_gemv(x, tabs, spec, scale, group)
            torch.cuda.synchronize()
            ran = {v: c - seen[v]
                   for v, c in ops.GEMV_VARIANT_LAUNCHES.items()}
            require(ran == {**dict.fromkeys(ran, 0), design: 2},
                    f"{what}: the fused GEMV ran the designs {ran}")
            require(torch.equal(got, again),
                    f"{what}: two launches of the {design} design differ")
            mx, ok = close(torch, got, want, rtol)
            record("fused_gemv", f"{what} B{rows} G{G} O{O} {dt} {design}, "
                   f"{note}", mx, ok, f"rtol {rtol}")
            del got, again
        require((sp.chunks, G, O, es) in ops._GEMV_CHECKED,
                f"{what}: the library's split was not checked")
        require((plan.rows, plan.rtiles, G, V, O, es)
                in ops._GEMV_STAGED_CHECKED,
                f"{what}: the library's staged plan was not checked")
        del tabs, x, want
        torch.cuda.empty_cache()

    what, rows, G, group, O, dt = COUNTED_GEMV
    dtype = getattr(torch, dt)
    V = 1 << (spec.bits * group)
    tabs = (torch.randn(G, V, O, generator=gen, device=dev)
            * (G * group) ** -0.5).to(dtype)
    x = torch.randn(rows, G * group, generator=gen, device=dev) * 2.0
    scale = float(scale_from_amax(0.6 * x.abs().max(), spec))
    plan = ops.gemv_staged_plan(rows, G, V, O, tabs.element_size())
    runs = {d: [ops._launch_gemv("fused_gemv", x, tabs, G, O, group, V * O,
                                 0, spec, scale, True, variant=d)
                for _ in range(2)] for d in ("staged", "split")}
    want, wc, wr = ops.gemv_stacked_plain(x, tabs[None], 0, spec, scale,
                                          group, with_stats=True)
    torch.cuda.synchronize()
    counts = {d: [(int(c), float(r)) for _, c, r in v]
              for d, v in runs.items()}
    same = all(c == [(int(wc), float(wr))] * 2 for c in counts.values())
    record("fused_gemv", f"{what} B{rows} G{G} O{O} {dt}: staged (cluster "
           f"{plan.cluster}) and split counts", 0.0, same and int(wc) > 0,
           "count, ratio exact, equal")
    for d, ((a, _, _), (b, _, _)) in runs.items():
        require(torch.equal(a, b), f"{what}: two {d} launches differ")
        mx, ok = close(torch, a, want, 1e-2)
        record("fused_gemv", f"{what} B{rows} G{G} O{O} {dt} {d}", mx, ok,
               "rtol 1e-2")
    del tabs, x, runs, want
    torch.cuda.empty_cache()


def check_ceilings(torch, ops, core, record, gen):
    """The kernels past the ceilings their launches once had, where the
    reference computes (CEILING_*): kernel 9 at 65,537 row chunks (4-bit,
    group 2, G 64, O 64, float32; the split forced, its row walk; then its
    staged design, the chooser's there) and at 230,000 segments of group 1
    (B 4, O 64; the slabs of the split and of the staged design, forced),
    kernel 1 at 65,537 row chunks (one
    bfloat16 layer, with its counters), kernel 3 at 65,537 row chunks (G
    32 into a 64-row pool, float32, one pointer out of range) and the
    staged conv (kernel 4) over 65,537 8x8 images (C 4, O 8; its code
    pre-pass walks the images).  Each runs twice, bit-identical; the split
    GEMVs' library plans are checked against ``kernels.ops``' mirror; each
    is held to its plain version at its kernel's tolerance (kernel 3 and
    the pre-pass exactly; the plain gathers run in row chunks of
    ``kernels.ref.PLAIN_CHUNK_ELEMS``).  Each case is freed before the
    next."""
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    t0 = time.perf_counter()

    def rand(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * s

    def scaled(x, sp=spec):
        return float(scale_from_amax(0.8 * x.abs().max(), sp))

    def twice(run, counts, want_design):
        seen = dict(counts)
        got, again = run(), run()
        torch.cuda.synchronize()
        ran = {v: c - seen[v] for v, c in counts.items()}
        require(ran == {**dict.fromkeys(counts, 0), want_design: 2},
                f"the ceiling case ran the designs {ran}")
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        require(all(torch.equal(a, b) for a, b in pairs),
                "two launches of a ceiling case differ")
        return got

    # -- kernel 9: the row walk, then the slabs
    B, G, O = CEILING_ROWS, 64, 64
    sp = ops.gemv_variant(B, G, O, 4)
    require(sp.chunks > ops.MAX_GRID_ROWS, f"the split {sp} walks no rows")
    tabs = rand(G, 256, O, s=G ** -0.5)
    x = rand(B, 2 * G, s=2.0)
    scale = scaled(x)
    with ops._gemv_forced("split"):  # the chooser stages so many rows
        got = twice(lambda: ops.pcilt_fused_gemv(x, tabs, spec, scale, 2),
                    ops.GEMV_VARIANT_LAUNCHES, "split")
    require((sp.chunks, G, O, 4) in ops._GEMV_CHECKED,
            "kernel 9's plan past the grid's rows was not checked")
    want = ops.fused_gemv_plain(x, tabs, spec, scale, 2)
    mx, ok = close(torch, got, want, 1e-4)
    record("fused_gemv", f"B{B} G{G} O{O} g2, {sp.chunks} row chunks", mx,
           ok, "rtol 1e-4")
    plan = ops.gemv_staged_plan(B, G, 256, O, 4)
    got = twice(lambda: ops.pcilt_fused_gemv(x, tabs, spec, scale, 2),
                ops.GEMV_VARIANT_LAUNCHES, "staged")
    mx, ok = close(torch, got, want, 1e-4)
    record("fused_gemv", f"B{B} G{G} O{O} g2, staged, {plan.rtiles} row "
           f"tiles of {plan.rows}", mx, ok, "rtol 1e-4")
    del tabs, x, got, want
    B, G = 4, CEILING_SEGS
    sp = ops.gemv_variant(B, G, O, 4)
    slab = ops.gemv_slab(sp, G)
    require(sp.cluster == ops.GEMV_MAX_CLUSTER and slab < -(-G // 16),
            f"the split {sp} at G {G} stages no slabs")
    tabs = rand(G, 16, O, s=G ** -0.5)
    x = rand(B, G, s=2.0)
    scale = scaled(x)
    got = twice(lambda: ops.pcilt_fused_gemv(x, tabs, spec, scale, 1),
                ops.GEMV_VARIANT_LAUNCHES, "split")
    require((sp.chunks, G, O, 4) in ops._GEMV_CHECKED,
            "kernel 9's plan past a cluster was not checked")
    with ops._gemv_forced("staged"):  # its ranks' offsets in slabs too
        staged = twice(lambda: ops.pcilt_fused_gemv(x, tabs, spec, scale, 1),
                       ops.GEMV_VARIANT_LAUNCHES, "staged")
    plan = ops.gemv_staged_plan(B, G, 16, O, 4)
    mx, ok = close(torch, staged, ops.fused_gemv_plain(x, tabs, spec, scale,
                                                       1), 1e-4)
    record("fused_gemv", f"B{B} G{G} O{O} g1, staged, slabs of "
           f"{ops.gemv_staged_slab(plan, G, 16)}", mx, ok, "rtol 1e-4")
    del staged
    mx, ok = close(torch, got, ops.fused_gemv_plain(x, tabs, spec, scale, 1),
                   1e-4)
    record("fused_gemv", f"B{B} G{G} O{O} g1, slabs of {slab}", mx, ok,
           "rtol 1e-4")
    del tabs, x, got
    torch.cuda.empty_cache()

    # -- kernel 1: one bfloat16 layer past the grid's rows, with counters
    B, G = CEILING_ROWS, 64
    x = rand(B, 2 * G, s=2.0)
    scale = scaled(x)
    w = rand(2 * G, O, s=(2 * G) ** -0.5)
    tabs = core.build_grouped_tables(w, spec, scale, 2)[None].to(
        torch.bfloat16).contiguous()
    got, cnt, ratio = twice(lambda: ops.pcilt_fused_gemv_stacked(
        x, tabs, 0, spec, scale, 2, with_stats=True),
        ops.GEMV_VARIANT_LAUNCHES, "split")
    require((ops.gemv_variant(B, G, O, 2).chunks, G, O, 2)
            in ops._GEMV_CHECKED,
            "kernel 1's plan past the grid's rows was not checked")
    want, wc, wr = ops.gemv_stacked_plain(x, tabs, 0, spec, scale, 2,
                                          with_stats=True)
    record("gemv_stacked", f"B{B} G{G} O{O} bf16 counters", 0.0,
           int(cnt) == int(wc) and float(ratio) == float(wr),
           "count, ratio exact")
    mx, ok = close(torch, got, want, 1e-2)
    record("gemv_stacked", f"B{B} G{G} O{O} bf16, past the grid's rows", mx,
           ok, "rtol 1e-2")
    del x, w, tabs, got, want

    # -- kernel 3 past the grid's rows
    B, G, X = CEILING_ROWS, 32, 64
    x = rand(B, 2 * G, s=2.0)
    scale = scaled(x)
    pool = rand(X, 256, O, s=0.05)
    idx = torch.randint(0, X, (G,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[5] = X  # out of range: adds nothing
    got = twice(lambda: ops.pcilt_shared_gemv(x, pool, idx, spec, scale, 2),
                ops.SHARED_GEMV_VARIANT_LAUNCHES, "split")
    require((B, G, O, 4) in ops._SHARED_CHECKED,
            "kernel 3's plan past the grid's rows was not checked")
    mx, ok = close(torch, got, ops.shared_gemv_plain(
        x, pool, idx, spec, scale, 2, split_order=True), 0.0, exact=True)
    record("shared_gemv", f"B{B} G{G} X{X} O{O}, past the grid's rows", mx,
           ok, "exact, the split's order")
    del x, pool, idx, got

    # -- the staged conv's pre-pass past the grid's z
    N, HW, C, O8 = CEILING_IMAGES, 8, 4, 8
    spec8 = QuantSpec(8, False)
    x = rand(N, HW, HW, C, s=2.0)
    scale = scaled(x, spec8)
    tabs = core.build_grouped_tables(
        rand(9 * C, O8, s=(9 * C) ** -0.5), spec8, scale, 1)
    require(ops.conv_variant(tabs.shape[1], 4) == "staged",
            "the ceiling conv does not take the staged design")
    got = twice(lambda: ops.pcilt_fused_conv2d(x, tabs, spec8, scale, 1, 3,
                                               3),
                ops.CONV_VARIANT_LAUNCHES, "staged")
    xp = padded(x, 3, 1)
    codes = ops._conv_codes(xp, spec8, scale)
    torch.cuda.synchronize()
    same = torch.equal(codes, ops.conv_codes_plain(xp, spec8, scale))
    record("fused_conv2d", f"{N} images {HW}x{HW} C{C} code pre-pass",
           0.0 if same else float("inf"), same, "exact")
    del codes
    mx, ok = close(torch, got, ops.fused_conv2d_plain(
        xp, tabs, spec8, scale, 1, 3, 3, 1).reshape(got.shape), 1e-4)
    record("fused_conv2d", f"{N} images {HW}x{HW} C{C} O{O8}", mx, ok,
           "rtol 1e-4")
    del x, xp, tabs, got
    torch.cuda.empty_cache()
    log(f"check ceilings: {time.perf_counter() - t0:.1f} s")


def conv_layers(cfg):
    """``(Cin, Cout)`` of each conv layer of a ``PaperCNN``."""
    return list(zip((cfg.in_channels,) + tuple(cfg.channels[:-1]),
                    cfg.channels))


def padded(x, k, stride):
    from repro_torch.core.lut_layers import conv_same_pads, pad_nhwc

    return pad_nhwc(x, conv_same_pads(x.shape[1], x.shape[2], k, k, stride))


def check_conv_kernels(torch, ops, record, gen):
    """The conv and host-packed kernels against their plain versions (run
    on the card): the paper's five layer shapes on a 64x48 image (8-bit
    asymmetric, group 1), one of them on an exact grid and one in bf16;
    ragged shapes (stride 2, symmetric 4-bit, group 2 with odd C so the
    alignment slot n_pad is 1, O = 13 or 45, a pool of X < G rows with one
    pointer out of range), f32, bf16 and exact.  The fused and shared conv
    run both designs on every case: the staged kernel (the wrappers'
    choice at V = 256; its code pre-pass held to its plain version
    exactly, and two launches bit-identical) and the kept kernel, forced;
    a V = 65536 case (8 bits x group 2) takes the kept kernel unforced.
    Exact grid: bit-equal; f32 within 1e-4 of max|plain| (another
    summation order over up to 5000 rows); bf16 within 1e-2 (one rounding
    of the f32 sum)."""
    from repro_torch.configs.paper_cnn import config
    from repro_torch.core.lut_layers import conv_offsets, flatten_filters
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import QuantSpec, calibrate
    from repro_torch.kernels.ref import pcilt_conv2d_ref, pcilt_gemv_ref

    dev = torch.device("cuda")
    cfg = config()
    k = cfg.k
    H, W = SMALL_HW
    cases = [(f"conv{i} {W}x{H} C{c} O{o}", c, o, cfg.act_spec, 1, 1, H, W,
              torch.float32, False, False)
             for i, (c, o) in enumerate(conv_layers(cfg))]
    sym4 = QuantSpec(4, symmetric=True)
    cases += [(f"conv1 {W}x{H} exact grid", 50, 80, cfg.act_spec, 1, 1, H, W,
               torch.float32, True, False),
              (f"conv2 {W}x{H} bf16", 80, 120, cfg.act_spec, 1, 1, H, W,
               torch.bfloat16, False, False),
              ("ragged s2 sym4 g2 C3 O13 9x11", 3, 13, sym4, 2, 2, 9, 11,
               torch.float32, False, True),
              ("ragged s2 sym4 g2 C3 O13 9x11 bf16", 3, 13, sym4, 2, 2, 9, 11,
               torch.bfloat16, False, True),
              ("ragged s2 sym4 g2 C5 O45 13x10 exact", 5, 45, sym4, 2, 2, 13,
               10, torch.float32, True, True),
              ("large V: 8-bit g2 C3 O13 9x11", 3, 13, cfg.act_spec, 2, 1, 9,
               11, torch.float32, False, True)]
    for what, C, O, spec, group, stride, h, w_, dt, exact, ragged in cases:
        if spec.symmetric:
            x = torch.randn(1, h, w_, C, generator=gen, device=dev)
        else:
            x = torch.rand(1, h, w_, C, generator=gen, device=dev) * 2
        if exact:
            w = torch.randint(-3, 4, (k, k, C, O), generator=gen,
                              device=dev).float()
            scale = 0.5
        else:
            w = torch.randn(k, k, C, O, generator=gen, device=dev) \
                * (k * k * C) ** -0.5
            scale = float(calibrate(x, spec))
        tabs = build_grouped_tables(flatten_filters(w, group), spec, scale,
                                    group).to(dt)
        G = tabs.shape[0]
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        tol = "exact" if exact else f"rtol {rtol}"
        xp = padded(x, k, stride)

        def check(kernel, got, want, note=""):
            torch.cuda.synchronize()
            mx, ok = close(torch, got, want.reshape(got.shape), rtol, exact)
            record(kernel, what + note, mx, ok, tol)

        if ragged:  # a pool of X < G rows, one pointer out of range
            X = G // 2
            pool = tabs[:X]
            idx = torch.randint(0, X, (G,), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[G // 3] = X + 7
        else:
            pool, idx = tabs, torch.arange(G, dtype=torch.int32, device=dev)
        fits = ops.conv_variant(tabs.shape[1], tabs.element_size())
        for kernel, run, plain in (
                ("fused_conv2d", lambda v: ops._fused_conv2d(
                    x, tabs, spec, scale, group, k, k, stride, variant=v),
                 ops.fused_conv2d_plain(xp, tabs, spec, scale, group, k, k,
                                        stride)),
                ("shared_conv2d", lambda v: ops._shared_conv2d(
                    x, pool, idx, spec, scale, group, k, k, stride,
                    variant=v),
                 ops.shared_conv2d_plain(xp, pool, idx, spec, scale, group,
                                         k, k, stride))):
            seen = dict(ops.CONV_VARIANT_LAUNCHES)
            got = run(None)  # the wrappers' choice
            diff = {v: c - seen[v] for v, c in
                    ops.CONV_VARIANT_LAUNCHES.items() if c != seen[v]}
            require(diff == {fits: 1}, f"{kernel} {what}: ran {diff}, "
                    f"conv_variant chose {fits}")
            check(kernel, got, plain)
            if fits == "staged":
                again = run("staged")
                torch.cuda.synchronize()
                require(torch.equal(got, again), f"{kernel} {what}: two "
                        "launches of the staged kernel differ")
                check(kernel, run("direct"), plain, " kept kernel")
        if fits == "staged":
            codes = ops._conv_codes(xp, spec, scale)
            torch.cuda.synchronize()
            want = ops.conv_codes_plain(xp, spec, scale)
            record("fused_conv2d", f"{what} code pre-pass", 0.0 if
                   torch.equal(codes, want) else float("inf"),
                   torch.equal(codes, want), "exact")
        off = conv_offsets(xp, spec, scale, group, k, k, stride, "VALID")
        if what.startswith("conv1 "):  # offsets out of range add nothing
            off.view(-1)[::97] = -1
            off.view(-1)[1::89] = tabs.shape[1]
            off.view(-1)[2::83] = 2 ** 31 - 1
            what += ", offsets out of range"
        flat = off.reshape(-1, G)
        host = ops.gemv_host_variant(flat.shape[0], G, tabs.shape[1], O,
                                     tabs.element_size())
        for kernel, run, plain in (
                ("gemv_host", lambda v: ops._gemv_host(flat, tabs, variant=v),
                 pcilt_gemv_ref(flat, tabs)),
                ("conv2d_host", lambda v: ops._conv2d_host(off, tabs,
                                                           variant=v),
                 pcilt_conv2d_ref(off, tabs))):
            if host == "direct":
                check(kernel, run(None), plain)
                continue
            others = [d for d in ops.gemv_host_candidates(
                flat.shape[0], G, tabs.shape[1], O, tabs.element_size())
                if d not in (host, "direct")]
            got, kept, forced = host_designs(torch, ops, run, host, others)
            check(kernel, got, plain, "" if host == "staged" else
                  f" {host} design")
            check(kernel, kept, plain, " kept kernel")
            for d, out in zip(others, forced):
                check(kernel, out, plain, f" {d} design forced")
        del tabs, pool, off, flat


def check_host_split(torch, ops, record, gen):
    """Kernel 6's split design at HOST_SPLIT_ROWS rows of each of
    HOST_SPLIT_CASES (the chooser's at up to 64 rows; forced at 1023, where
    the gate's rows take the staged design), with offsets of -1, V and
    2**31 - 1 mixed in (they add nothing): the split design twice,
    bit-identical, and the kept direct design forced, each against its
    plain version at kernel 9's tolerances: an exact grid bit-equal;
    float32 within 1e-4 of max|plain| (the slices sum in another order);
    bfloat16 within 1e-2 (one rounding of the float32 sum).  The library's
    split of each shape is checked against ``gemv_variant`` at its first
    launch."""
    from repro_torch.kernels.ref import pcilt_gemv_ref

    dev = torch.device("cuda")
    for what, G, V, O, dt, exact in HOST_SPLIT_CASES:
        dtype = getattr(torch, dt)
        if exact:
            tabs = torch.randint(-3, 4, (G, V, O), generator=gen, device=dev)
        else:
            tabs = torch.randn(G, V, O, generator=gen, device=dev)
        tabs = tabs.to(torch.float32).to(dtype)
        es = tabs.element_size()
        rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        tol = "exact" if exact else f"rtol {rtol}"
        for M in HOST_SPLIT_ROWS:
            require(M > 64 or ops.gemv_host_variant(M, G, V, O, es)
                    == "split", f"kernel 6 at M {M}, {what} is not the "
                    f"split design")
            off = torch.randint(0, V, (M, G), generator=gen, device=dev,
                                dtype=torch.int32)
            off.view(-1)[::7] = -1
            off.view(-1)[1::11] = V
            off.view(-1)[2::13] = 2 ** 31 - 1
            got, kept, _ = host_designs(
                torch, ops, lambda v: ops._gemv_host(
                    off, tabs, variant=v or "split"), "split")
            require((ops.gemv_variant(M, G, O, es).chunks, G, O, es)
                    in ops._HOST_SPLIT_CHECKED,
                    f"kernel 6 at M {M}, {what}: the library's split was "
                    f"not checked")
            want = pcilt_gemv_ref(off, tabs)
            for design, out in (("split", got), ("kept design", kept)):
                mx, ok = close(torch, out, want, rtol, exact)
                record("gemv_host", f"M{M} {what}, offsets out of range, "
                       f"{design}", mx, ok, tol)
            del off, got, kept, want
        del tabs
        torch.cuda.empty_cache()


def check_slice3_kernels(torch, ops, record, gen):
    """The paired stacked GEMV, the unstacked fused and paired GEMVs and the
    host-packed dwconv against their plain versions (run on the card).

    Paired stacked: the paired decode's wz and wo at B = 4 on segment-major
    ``[G2, 24, 256, O]`` stacks, layer 23 (element offsets up to 1.8e9),
    float32, bfloat16 and an exact grid; ragged: odd G (the phantom
    segment), O = 13, B = 3.  Paired: the parity probe's shapes, bf16,
    ragged.  Fused: qwen3-0.6b's gate and down projections, bf16, exact
    grid, ragged.  Counters bit-exact.  Exact grid: bit-equal; float32
    within 1e-4 of max|plain| (sums over up to 1536 rows); bfloat16 within
    1e-2 (one rounding of the float32 sum).  Host dwconv: exact, with
    offsets outside [0, V) giving 0."""
    import torch.nn.functional as F

    from repro_torch.core.pcilt import (build_grouped_tables,
                                        build_paired_stacked_tables,
                                        build_paired_tables)
    from repro_torch.core.quantization import QuantSpec, scale_from_amax
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    dev = torch.device("cuda")
    group = 2
    spec2, spec4 = QuantSpec(2, True), QuantSpec(4, True)

    def weights(shape, exact):
        if exact:
            return torch.randint(-3, 4, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev) \
            * shape[-2] ** -0.5

    def signal(rows, n, spec, exact):
        x = torch.randn(rows, n, generator=gen, device=dev) * 2.0
        s = 0.5 if exact else float(scale_from_amax(0.8 * x.abs().max(),
                                                    spec))
        return x, s

    def held(kernel, what, run, want, dt, exact, stats):
        for design, got in zip(("", " kept design"),
                               gemv_designs(torch, ops, run)):
            check(kernel, what + design, got, want, dt, exact, stats)

    def check(kernel, what, got, want, dt, exact, stats):
        if stats:
            (got, gc, gr), (want, wc, wr) = got, want
            record(kernel, f"{what} counters", 0.0,
                   int(gc) == int(wc) and float(gr) == float(wr),
                   "count, ratio exact")
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        mx, ok = close(torch, got, want, rtol, exact)
        record(kernel, f"{what} counters={int(stats)}", mx, ok,
               "exact" if exact else f"rtol {rtol}")

    # -- paired stacked GEMV (#8): [G2, L, 256, O] at the decode's width
    cases = [(f"{k} G2{G2} O{O} L{N_LAYERS}", B, G2, O, N_LAYERS,
              torch.float32, False, False)
             for k, (G2, O) in PAIRED_SHAPES.items()]
    cases += [("wz G2192 O1536 L24 bf16", B, 192, 1536, N_LAYERS,
               torch.bfloat16, False, False),
              ("wo G2384 O768 L24 exact grid", B, 384, 768, N_LAYERS,
               torch.float32, True, False),
              ("ragged B3 G5 (phantom) O13 L3", 3, 3, 13, 3, torch.float32,
               False, True)]
    for what, rows, G2, O, L, dt, exact, odd in cases:
        n = G2 * 2 * group - (group if odd else 0)  # odd G: phantom pad
        w = weights((L, n, O), exact)
        x, scale = signal(rows, n, spec2, exact)
        stack = build_paired_stacked_tables(w, spec2, [scale] * L, group,
                                            dtype=dt)
        del w
        xp = F.pad(x, (0, group)) if odd else x
        for stats in (False, True):
            held("gemv_paired_stacked", what,
                 lambda: ops.pcilt_fused_gemv_paired_stacked(
                     xp, stack, L - 1, spec2, scale, group, with_stats=stats),
                 ops.gemv_paired_stacked_plain(
                     xp, stack, L - 1, spec2, scale, group, with_stats=stats),
                 dt, exact, stats)
        del stack

    # -- paired GEMV (#10): the parity probe's shapes, bf16, ragged
    for what, rows, n, O, dt, exact in [
            ("probe B4 64->128 exact grid", B, 64, 128, torch.float32, True),
            ("wz B4 768->1536", B, 768, 1536, torch.float32, False),
            ("wz B4 768->1536 bf16", B, 768, 1536, torch.bfloat16, False),
            ("ragged B3 G5 (phantom) O13", 3, 10, 13, torch.float32,
             False)]:
        w = weights((n, O), exact)
        x, scale = signal(rows, n, spec2, exact)
        tabs = build_paired_tables(w, spec2, scale, group).to(dt)
        xp = F.pad(x, (0, tabs.shape[0] * 2 * group - n))
        for stats in (False, True):
            held("gemv_paired", what,
                 lambda: ops.pcilt_fused_gemv_paired(
                     xp, tabs, spec2, scale, group, with_stats=stats),
                 ops.gemv_paired_plain(xp, tabs, spec2, scale, group,
                                       with_stats=stats),
                 dt, exact, stats)

    # -- fused GEMV (#9): qwen3-0.6b's gate and down projections
    for what, rows, n, O, dt, exact in [
            (f"gate B4 {QWEN_D}->{QWEN_FF}", B, QWEN_D, QWEN_FF,
             torch.float32, False),
            (f"down B4 {QWEN_FF}->{QWEN_D}", B, QWEN_FF, QWEN_D,
             torch.float32, False),
            (f"gate B4 {QWEN_D}->{QWEN_FF} bf16", B, QWEN_D, QWEN_FF,
             torch.bfloat16, False),
            (f"gate B4 {QWEN_D}->{QWEN_FF} exact grid", B, QWEN_D, QWEN_FF,
             torch.float32, True),
            ("ragged B3 G7 O13", 3, 14, 13, torch.float32, False)]:
        w = weights((n, O), exact)
        x, scale = signal(rows, n, spec4, exact)
        tabs = build_grouped_tables(w, spec4, scale, group).to(dt)
        del w
        held("fused_gemv", what,
             lambda: ops.pcilt_fused_gemv(x, tabs, spec4, scale, group),
             ops.fused_gemv_plain(x, tabs, spec4, scale, group), dt, exact,
             False)
        del tabs

    # -- host-packed dwconv (#12): the single-layer signal's offsets, both
    #    designs (the staged one twice), offsets out of range
    for what, shape, V, dt in [
            (f"B4 T{CONV_T} C{CONV_C} V256", (B, CONV_T, CONV_C), 256,
             torch.float32),
            (f"B4 T{CONV_T} C{CONV_C} V256 bf16", (B, CONV_T, CONV_C), 256,
             torch.bfloat16),
            ("ragged B3 T9 C33 V16", (3, 9, 33), 16, torch.float32),
            ("ragged B2 T5 C20 V64 bf16", (2, 5, 20), 64, torch.bfloat16)]:
        tabs = torch.randn(shape[-1], V, generator=gen, device=dev).to(dt)
        off = torch.randint(0, V, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        off[0, 0, 0], off[-1, -1, -1] = -1, V + 3
        want = pcilt_dwconv1d_ref(off, tabs)
        for design, got in zip(("", " again", " kept design"),
                               dwconv_host_designs(torch, ops, off, tabs)):
            mx, ok = close(torch, got, want, 0.0, exact=True)
            record("dwconv1d_host", f"{what}, offsets out of range{design}",
                   mx, ok and float(got[0, 0, 0]) == 0.0
                   and float(got[-1, -1, -1]) == 0.0, "exact")


def qwen_plans(torch, w):
    """Phase 10's SegmentPlans over the gate's ``QWEN_D`` positions (paper
    Fig. 7), from ``w [QWEN_D, QWEN_FF]``: ``perm`` pairs a seeded
    permutation of the positions; ``pruned`` pairs the 895 positions of
    largest row norm in ascending order, its last slot -1; ``reuse`` is the
    contiguous plan plus 64 segments that repeat the 128 positions of
    largest row norm."""
    from repro_torch.core.offsets import SegmentPlan

    cpu = torch.Generator().manual_seed(10)
    norms = w.norm(dim=1)

    def top(k):
        return torch.topk(norms, k).indices.sort().values.int().cpu()

    perm = torch.randperm(QWEN_D, generator=cpu).int()
    pruned = torch.cat([top(895), torch.tensor([-1], dtype=torch.int32)])
    reuse = torch.cat([torch.arange(QWEN_D, dtype=torch.int32), top(128)])
    return {name: SegmentPlan(t.numpy().reshape(-1, 2))
            for name, t in (("perm", perm), ("pruned", pruned),
                            ("reuse", reuse))}


def plan_offsets(torch, x, plan, spec, scale):
    """The offsets kernel 11 packs: ``x`` gathered by the plan, 0.0 in the
    unused slots, quantized and packed -> ``[B, G]``."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import quantize

    idx = plan.on(x.device).long().reshape(-1)
    xg = torch.where(idx >= 0, x[:, idx.clamp_min(0)], 0.0)
    return pack_offsets(quantize(xg, spec, scale), spec.bits, plan.group)


def check_plan_kernel(torch, ops, record, gen):
    """Kernel 11 (the plan GEMV) against its plain version: qwen3-0.6b's
    gate under phase 10's ``perm`` plan at B = 4 (float32 and bfloat16),
    an exact grid with a -1 slot and a reused position (bit-equal), and a
    ragged case (B 3, n 21, odd G 7, O 13, -1 slots, reused positions).
    Float32 within 1e-4 of max|plain| (sums over 512 rows), bfloat16
    within 1e-2 (one rounding of the float32 sum)."""
    import numpy as np

    from repro_torch.core.offsets import SegmentPlan
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    w = torch.randn(QWEN_D, QWEN_FF, generator=gen, device=dev) \
        * QWEN_D ** -0.5
    perm = qwen_plans(torch, w)["perm"]
    rng = np.random.default_rng(11)
    ragged = rng.integers(0, 21, size=(7, 2)).astype(np.int32)
    ragged[1, 0] = ragged[5, 1] = -1
    exact = rng.permutation(64).astype(np.int32)
    exact[9] = -1  # position 9's slot unused ...
    exact = np.concatenate([exact, exact[:2]])  # ... and two reused
    cases = [("gate perm B4 1024->3072", perm, w, B, torch.float32, False),
             ("gate perm B4 1024->3072 bf16", perm, w, B, torch.bfloat16,
              False),
             ("exact grid B4 64->128, -1 slot, reuse",
              SegmentPlan(exact.reshape(-1, 2)),
              torch.randint(-3, 4, (64, 128), generator=gen,
                            device=dev).float(), B, torch.float32, True),
             ("ragged B3 n21 G7 O13, -1 slots, reuse", SegmentPlan(ragged),
              torch.randn(21, 13, generator=gen, device=dev), 3,
              torch.float32, False)]
    for what, plan, wc, rows, dt, ex in cases:
        n = wc.shape[0]
        if ex:
            x = torch.randint(-2, 2, (rows, n), generator=gen,
                              device=dev).float() * 0.5
            scale = 0.5
        else:
            x = torch.randn(rows, n, generator=gen, device=dev) * 2.0
            scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
        tabs = build_grouped_tables(wc, spec, scale, 2, plan=plan).to(dt)
        idx = plan.on(dev)
        runs = gemv_designs(torch, ops, lambda: ops.pcilt_fused_gemv_plan(
            x, tabs, idx, spec, scale, 2))
        want = ops.gemv_plan_plain(x, tabs, idx, spec, scale, 2)
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        for design, got in zip(("", " kept design"), runs):
            mx, ok = close(torch, got, want, rtol, ex)
            record("gemv_plan", what + design, mx, ok,
                   "exact" if ex else f"rtol {rtol}")
        del tabs


def time_kernels(torch, ops, core, report):
    """Per-launch device time of each kernel at the decode shapes, beside
    its plain version, a library call and the least time the card could
    take."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               quantize, scale_from_amax)

    dev = torch.device("cuda")
    spec = QuantSpec(bits=4, symmetric=True)
    group, L = 2, 8
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = L2Flush(torch)
    rows = {}

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

    def add(key, kernel, shape, k, plain, lib, bound_ms, launches_per_step,
            direct=None):
        rows[key] = {"kernel": kernel, "shape": shape, "ms": k["ms"],
                     "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
                     "plain_ms": plain["ms"], "plain_warm_ms": plain["warm_ms"],
                     "library_ms": lib["ms"], "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "launches_per_step": launches_per_step}
        kept = ""
        if direct is not None:
            rows[key].update(variant="split", direct_ms=direct["ms"],
                             direct_warm_ms=direct["warm_ms"])
            kept = f"  kept design {direct['ms'] * 1e3:8.2f} us"
        log(f"time  {kernel:13s} {key:26s} kernel {k['ms'] * 1e3:8.2f} us "
            f"(warm {k['warm_ms'] * 1e3:8.2f}, events "
            f"{k['events_ms'] * 1e3:8.2f}){kept}  plain "
            f"{plain['ms'] * 1e3:8.2f} us  library {lib['ms'] * 1e3:8.2f} us "
            f"(warm {lib['warm_ms'] * 1e3:8.2f})  bound {bound_ms * 1e3:7.2f} "
            f"us  x{launches_per_step}/step")

    def scale_for(x):
        return float(scale_from_amax(0.8 * x.abs().max(), spec))

    # -- stacked GEMV at each projection shape, in the variants a decode step
    #    launches: (shape, counters) -> launches per step (wx and wo count)
    per_step = {("wz,wx", False): 24, ("wz,wx", True): 24,
                ("wB,wC", False): 48, ("wdt", False): 24, ("wo", True): 24}
    for key, (G, O) in PROJ_SHAPES.items():
        n = G * group
        w = torch.randn(L, n, O, generator=gen, device=dev) * n ** -0.5
        x = torch.randn(B, n, generator=gen, device=dev)
        scale = scale_for(x)
        tabs = torch.empty((L, G, 256, O), device=dev)
        for l in range(L):
            tabs[l] = core.build_grouped_tables(w[l], spec, scale, group)
        off = pack_offsets(quantize(x, spec, scale), spec.bits, group)
        uniq_rows = sum(len(torch.unique(off[:, g])) for g in range(G))
        bound = (uniq_rows * O * 4 + x.numel() * 4 + B * O * 4) \
            / HBM_BYTES_PER_S * 1e3
        xq = fake_quant(x, spec, scale)
        lib = timed([lambda l=l: torch.matmul(xq, w[l]) for l in range(L)] * 4)
        for stats in (False, True):
            if (key, stats) not in per_step:
                continue
            calls = [lambda l=l: ops.pcilt_fused_gemv_stacked(
                x, tabs, l, spec, scale, group, with_stats=stats)
                for l in range(L)] * 4
            plain = [lambda l=l: ops.gemv_stacked_plain(
                x, tabs, l, spec, scale, group, with_stats=stats)
                for l in range(L)] * 2
            k = timed(calls, GEMV_SPLIT_KERNEL)
            d = timed(kept_design(ops, calls), GEMV_DIRECT_KERNEL)
            p = timed(plain)
            add(f"{key}{' counters' if stats else ''}", "gemv_stacked",
                [L, G, 256, O], k, p, lib, bound, per_step[(key, stats)], d)
        del tabs, w

    # -- dwconv over the [4, 4, 1792] decode window (counters: the engine's)
    C = 1792
    filt = torch.randn(L, 4, C, generator=gen, device=dev) * 0.5
    win = torch.randn(B, 4, C, generator=gen, device=dev)
    scale = scale_for(win)
    tabs = torch.empty((L, C, 1 << 16), device=dev)
    for l in range(L):
        tabs[l] = core.build_dwconv_tables(filt[l], spec, scale)
    codes = quantize(win, spec, scale).int()
    off = sum(codes[:, j] << (4 * j) for j in range(4))  # [B, C]
    uniq = sum(len(torch.unique(off[:, c])) for c in range(C))
    bound = (uniq * 32 + win.numel() * 4 + B * C * 4) / HBM_BYTES_PER_S * 1e3
    wq = fake_quant(win, spec, scale)
    lib = timed([lambda l=l: torch.einsum("bkc,kc->bc", wq, filt[l])
                 for l in range(L)] * 4)

    def window(variant):
        return [lambda l=l: ops._fused_dwconv1d(
            win, tabs[l], spec, scale, 4, "VALID", with_stats=True,
            variant=variant) for l in range(L)] * 4

    k = timed(window("tiled"), DWCONV_TILED_KERNEL)
    d = timed(window("direct"), DWCONV_DIRECT_KERNEL)
    fill = timed(window("direct"))  # the kept design and its stats fill
    p = timed([lambda l=l: ops.dwconv1d_plain(
        win, tabs[l], spec, scale, 4, with_stats=True)
        for l in range(L)] * 2)
    add("window counters", "dwconv1d", [L, C, 1 << 16], k, p, lib, bound, 24)
    rows["window counters"].update(
        variant="tiled", direct_ms=d["ms"], direct_warm_ms=d["warm_ms"],
        direct_with_fill_ms=fill["ms"])
    log(f"      kept design {d['ms'] * 1e3:8.2f} us, with its stats fill "
        f"{fill['ms'] * 1e3:8.2f} us")
    del tabs

    # -- dwconv over the full [4, 2048, 1792] signal (2-bit, CAUSAL; the
    #    single-layer path's shape), counters on
    spec2 = QuantSpec(bits=2, symmetric=True)
    sig = torch.randn(B, CONV_T, C, generator=gen, device=dev)
    s2 = float(scale_from_amax(0.8 * sig.abs().max(), spec2))
    tab2 = core.build_dwconv_tables(filt[0], spec2, s2)
    sp = torch.nn.functional.pad(sig, (0, 0, CONV_K - 1, 0))
    codes = quantize(sp, spec2, s2).int()
    off = sum(codes[:, j:j + CONV_T] << (2 * j) for j in range(CONV_K))
    cells = len(torch.unique(torch.arange(C, device=dev) * 256 + off.long()))
    bound = (cells * 4 + sp.numel() * 4 + sig.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3

    def signal(variant):
        return [lambda: ops._fused_dwconv1d(
            sig, tab2, spec2, s2, CONV_K, "CAUSAL", with_stats=True,
            variant=variant)] * 4

    sq = fake_quant(sp, spec2, s2)
    w2 = filt[0]
    lib = timed([lambda: torch.einsum(
        "btkc,kc->btc", sq.unfold(1, CONV_K, 1).transpose(2, 3), w2)] * 4)
    k = timed(signal("tiled"), DWCONV_TILED_KERNEL)
    d = timed(signal("direct"), DWCONV_DIRECT_KERNEL)
    p = timed([lambda: ops.dwconv1d_plain(sp, tab2, spec2, s2, CONV_K,
                                          with_stats=True)] * 2)
    add("signal counters", "dwconv1d", [B, CONV_T, C, 256], k, p, lib, bound,
        0, d)
    rows["signal counters"]["variant"] = "tiled"
    del tab2, sig, sp, sq, codes, off

    # -- shared-pool head: the engine's pool of 384 distinct segments
    #    (18.4 GiB), x rotating over 4 inputs; at B = 4 (the engine's) and
    #    B = 1, each beside the kept design forced and matmul at its batch
    G, O = 384, 50288
    blocks = torch.randn(G * group, O, generator=gen, device=dev) * 0.05
    scale = scale_for(torch.randn(B, G * group, generator=gen, device=dev))
    shared = core.build_shared_grouped_tables(blocks, spec, scale, group)
    pool, idx = shared.pool, shared.seg_idx
    X = pool.shape[0]
    require(X == G, f"head pool has {X} rows, the engine's {G}")
    kq = torch.randn(G * group, O, generator=gen, device=dev) * 0.05
    for key, rows_n in (("head", B), ("head B1", 1)):
        xs = [torch.randn(rows_n, G * group, generator=gen, device=dev)
              for _ in range(4)]
        cells = 0
        for x in xs:
            o = pack_offsets(quantize(x, spec, scale), spec.bits, group)
            cells += len(torch.unique(idx.long()[None] * 256 + o.long()))
        bound = (cells / len(xs) * O * 4 + xs[0].numel() * 4 + G * 4
                 + rows_n * O * 4) / HBM_BYTES_PER_S * 1e3
        xqs = [fake_quant(x, spec, scale) for x in xs]
        lib = timed([lambda q=q: torch.matmul(q, kq) for q in xqs] * 4)
        calls = [lambda x=x: ops.pcilt_shared_gemv(
            x, pool, idx, spec, scale, group) for x in xs] * 4
        k = timed(calls, SHARED_SPLIT_KERNEL)
        d = timed([lambda x=x: ops._shared_gemv(
            x, pool, idx, spec, scale, group, variant="direct")
            for x in xs] * 4, SHARED_DIRECT_KERNEL)
        p = timed([lambda x=x: ops.shared_gemv_plain(
            x, pool, idx, spec, scale, group) for x in xs] * 2)
        add(key, "shared_gemv", [X, 256, O], k, p, lib, bound,
            1 if rows_n == B else 0, d)
        rows[key]["batch"] = rows_n
    del pool, shared, blocks, flush
    report["timing"] = rows
    return rows


def time_slice3_kernels(torch, ops, report, rows):
    """Phase 4 for the paired stacked GEMV (#8: the paired decode's five
    projection shapes at B = 4, on segment-major [G2, 24, 256, O] stacks,
    with counters where the step uses them), the fused GEMV (#9:
    qwen3-0.6b's gate, 4-bit, group 2), the paired GEMV (#10: the parity
    probe at wz's width) and the host-packed dwconv (#12: the [4, 2048,
    1792] single-layer signal, 2-bit, 4 taps): kernel (the fused GEMVs
    beside their kept design, forced), plain version at the same shape,
    library call and bound."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.pcilt import (build_grouped_tables,
                                        build_paired_stacked_tables,
                                        build_paired_tables)
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               quantize, scale_from_amax)
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    dev = torch.device("cuda")
    group, L = 2, N_LAYERS
    spec2, spec4 = QuantSpec(2, True), QuantSpec(4, True)
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = L2Flush(torch)

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

    def add(key, kernel, shape, k, plain, lib, nbytes, fetch_adds, launches,
            per, direct=None):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fetch_adds / F32_OPS_PER_S * 1e3
        rows[key] = {"kernel": kernel, "shape": shape, "ms": k["ms"],
                     "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
                     "plain_ms": plain["ms"], "plain_warm_ms": plain["warm_ms"],
                     "plain_shape": "the kernel's", "library_ms": lib["ms"],
                     "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "bytes": nbytes, "fetch_adds": fetch_adds,
                     f"launches_per_{per}": launches}
        kept = ""
        if direct is not None:
            rows[key].update(variant="split", direct_ms=direct["ms"],
                             direct_warm_ms=direct["warm_ms"])
            kept = f"  kept design {direct['ms'] * 1e3:8.2f} us"
        log(f"time  {kernel:19s} {key:26s} kernel {k['ms'] * 1e3:8.2f} us "
            f"(warm {k['warm_ms'] * 1e3:8.2f}){kept}  plain "
            f"{plain['ms'] * 1e3:9.2f} us  library {lib['ms'] * 1e3:8.2f} us"
            f"  bound {max(b_ms, o_ms) * 1e3:7.2f} us "
            f"({rows[key]['bound_by']})  x{launches}/{per}")

    def gemv_bytes(x, off, O, out_rows):
        """Distinct table rows this run's offsets fetch, x read once, the
        output written once (float32)."""
        uniq = sum(len(torch.unique(off[:, g])) for g in range(off.shape[1]))
        return uniq * O * 4 + x.numel() * 4 + out_rows * O * 4

    # -- #8 on the paired decode's stacks; launches per step as the engine
    #    makes them (wz and wo share their shapes with wx and the counters)
    per_step = {("wz", False): 24, ("wz", True): 24, ("wB,wC", False): 48,
                ("wdt", False): 24, ("wo", True): 24, ("wo", False): 0}
    for key, (G2, O) in PAIRED_SHAPES.items():
        n = G2 * 2 * group
        w = torch.randn(L, n, O, generator=gen, device=dev) * n ** -0.5
        x = torch.randn(B, n, generator=gen, device=dev)
        scale = float(scale_from_amax(0.8 * x.abs().max(), spec2))
        stack = build_paired_stacked_tables(w, spec2, [scale] * L, group)
        off = pack_offsets(quantize(x, spec2, scale), spec2.bits, 2 * group)
        nbytes = gemv_bytes(x, off, O, B)
        xq = fake_quant(x, spec2, scale)
        lays = range(min(8, L))
        lib = timed([lambda l=l: torch.matmul(xq, w[l]) for l in lays] * 4)
        for stats in (False, True):
            if (key, stats) not in per_step:
                continue
            calls = [lambda l=l: ops.pcilt_fused_gemv_paired_stacked(
                x, stack, l, spec2, scale, group, with_stats=stats)
                for l in lays] * 4
            plain = [lambda l=l: ops.gemv_paired_stacked_plain(
                x, stack, l, spec2, scale, group, with_stats=stats)
                for l in lays] * 2
            add(f"paired {key}{' counters' if stats else ''}",
                "gemv_paired_stacked", [G2, L, 256, O],
                timed(calls, GEMV_SPLIT_KERNEL), timed(plain), lib, nbytes,
                B * G2 * O, per_step[(key, stats)], "step",
                timed(kept_design(ops, calls), GEMV_DIRECT_KERNEL))
        del stack, w

    # -- #9: qwen3-0.6b's gate projection (1.61 GB of float32 tables)
    n, O = QWEN_D, QWEN_FF
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec4))
    tabs = build_grouped_tables(w, spec4, scale, group)
    nbytes = statistics.mean(gemv_bytes(
        x, pack_offsets(quantize(x, spec4, scale), 4, group), O, B)
        for x in xs)
    xqs = [fake_quant(x, spec4, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, w) for q in xqs] * 4)
    calls = [lambda x=x: ops.pcilt_fused_gemv(x, tabs, spec4, scale, group)
             for x in xs] * 4
    k = timed(calls, GEMV_SPLIT_KERNEL)
    d = timed(kept_design(ops, calls), GEMV_DIRECT_KERNEL)
    p = timed([lambda x=x: ops.fused_gemv_plain(x, tabs, spec4, scale, group)
               for x in xs] * 2)
    add("fused_gemv gate", "fused_gemv", [n // group, 256, O], k, p, lib,
        nbytes, B * (n // group) * O, 1, "projection", d)
    del tabs, w

    # -- #9 at llava's down projection, group 1 (WIDE_GEMV[0]: 3.76 GB of
    #    float32 tables): the staged design (the chooser's at B 32) beside
    #    the split forced (its cluster grown to fit its offsets); bound: the
    #    distinct rows its offsets fetch, x and the output once
    what, rows_, n, O, _ = WIDE_GEMV[0]
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    xs = [torch.randn(rows_, n, generator=gen, device=dev) for _ in range(2)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec4))
    tabs = build_grouped_tables(w, spec4, scale, 1)
    seg = torch.arange(n, device=dev) * 16
    nbytes = statistics.mean(
        len(torch.unique(quantize(x, spec4, scale).long() + seg)) * O * 4
        + x.numel() * 4 + rows_ * O * 4 for x in xs)
    xqs = [fake_quant(x, spec4, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, w) for q in xqs] * 2)
    calls = [lambda x=x: ops.pcilt_fused_gemv(x, tabs, spec4, scale, 1)
             for x in xs] * 2
    seen = ops.GEMV_VARIANT_LAUNCHES["staged"]
    k = timed(calls, GEMV_STAGED_KERNEL)
    require(ops.GEMV_VARIANT_LAUNCHES["staged"] > seen,
            f"{what}: kernel 9 did not take the staged design at B {rows_}")
    ks = timed(kept_design(ops, calls, "split"), GEMV_SPLIT_KERNEL)
    p = timed([lambda: ops.fused_gemv_plain(xs[0], tabs, spec4, scale, 1)])
    sp = ops.gemv_variant(rows_, n, O, 4)
    plan = ops.gemv_staged_plan(rows_, n, 16, O, 4)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows["fused_gemv gate"]["wide"] = {
        "what": what, "shape": [rows_, n, 16, O], "variant": "staged",
        "row_tile": plan.rows, "staged_cluster": plan.cluster,
        "ms": k["ms"], "warm_ms": k["warm_ms"], "split_ms": ks["ms"],
        "split_warm_ms": ks["warm_ms"], "cluster": sp.cluster,
        "plain_ms": p["ms"], "library_ms": lib["ms"],
        "library_call": LIB_NOTE["fused_gemv"],
        "bound_ms": b_ms, "bound_by": "bytes", "bytes": nbytes,
        "table_bytes_ms": tabs.numel() * 4 / HBM_BYTES_PER_S * 1e3}
    log(f"time  fused_gemv          {what} B{rows_} G{n} O{O} group 1: "
        f"staged (rows {plan.rows}, cluster {plan.cluster}) "
        f"{k['ms']:8.3f} ms (warm {k['warm_ms']:8.3f})  split (cluster "
        f"{sp.cluster}) {ks['ms']:8.3f} ms  plain {p['ms']:8.3f} ms  matmul "
        f"{lib['ms']:8.3f} ms  bound {b_ms:7.3f} ms (bytes; the whole "
        f"table {rows['fused_gemv gate']['wide']['table_bytes_ms']:.3f})")
    del tabs, w, xs, xqs

    # -- #10: the parity probe at wz's width, [4, 768] -> 1536, 2-bit
    n, O = 768, 1536
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec2))
    tabs = build_paired_tables(w, spec2, scale, group)
    nbytes = statistics.mean(gemv_bytes(
        x, pack_offsets(quantize(x, spec2, scale), 2, 2 * group), O, B)
        for x in xs)
    xqs = [fake_quant(x, spec2, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, w) for q in xqs] * 4)
    calls = [lambda x=x: ops.pcilt_fused_gemv_paired(
        x, tabs, spec2, scale, group) for x in xs] * 4
    k = timed(calls, GEMV_SPLIT_KERNEL)
    d = timed(kept_design(ops, calls), GEMV_DIRECT_KERNEL)
    p = timed([lambda x=x: ops.gemv_paired_plain(x, tabs, spec2, scale,
                                                 group) for x in xs] * 2)
    add("gemv_paired wz", "gemv_paired", [n // (2 * group), 256, O], k, p,
        lib, nbytes, B * (n // (2 * group)) * O, 1, "probe", d)
    del tabs, w

    # -- #12: the single-layer signal's offsets, [4, 2048, 1792], V = 256,
    #    float32 and bfloat16 tables, beside the kept design forced
    V = 1 << (spec2.bits * CONV_K)
    x = torch.randn(B, CONV_T + CONV_K - 1, CONV_C, generator=gen, device=dev)
    codes = quantize(x, spec2, float(scale_from_amax(x.abs().max(), spec2)))
    codes = codes.int()
    off = sum(codes[:, j:j + CONV_T] << (spec2.bits * j)
              for j in range(CONV_K)).contiguous()
    idx = (torch.arange(CONV_C, device=dev) * V + off.long()).contiguous()
    cells = len(torch.unique(idx))
    for key, dt in (("dwconv1d_host signal", torch.float32),
                    ("dwconv1d_host signal bf16", torch.bfloat16)):
        tabs = torch.randn(CONV_C, V, generator=gen, device=dev).to(dt)
        es = tabs.element_size()
        nbytes = cells * es + off.numel() * 4 + off.numel() * es
        lib = timed([lambda: torch.take(tabs, idx)] * 4)
        k = timed([lambda: ops.pcilt_dwconv1d(off, tabs)] * 4,
                  DWCONV_STAGED_KERNEL)
        d = timed([lambda: ops._dwconv1d_host(off, tabs, variant="direct")]
                  * 4, DWCONV_HOST_KERNEL)
        p = timed([lambda: pcilt_dwconv1d_ref(off, tabs)] * 2)
        add(key, "dwconv1d_host", [B, CONV_T, CONV_C, V], k, p, lib, nbytes,
            0, 1 if dt == torch.float32 else 0, "layer call", d)
        rows[key]["variant"] = "staged"
        del tabs
    del x, off, idx, flush


def time_plan_kernel(torch, ops, report, rows):
    """Phase 4 for kernel 11, the plan GEMV, at qwen3-0.6b's gate under
    phase 10's ``perm`` plan (G 512, 1.61 GB of float32 tables, B = 4, x
    rotating over 4 inputs): kernel, plain version at the same shape,
    ``torch.matmul`` of the quantized, gathered input by the gathered
    weights, and the bound (distinct rows fetched, x and the plan read
    once, the output written once)."""
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               scale_from_amax)

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = L2Flush(torch)
    n, O = QWEN_D, QWEN_FF
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    plan = qwen_plans(torch, w)["perm"]
    idx = plan.on(dev)
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec))
    tabs = build_grouped_tables(w, spec, scale, 2, plan=plan)
    G = plan.n_segments
    uniq = statistics.mean(
        sum(len(torch.unique(off[:, g])) for g in range(G))
        for off in (plan_offsets(torch, x, plan, spec, scale) for x in xs))
    nbytes = uniq * O * 4 + B * n * 4 + idx.numel() * 4 + B * O * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = B * G * O / F32_OPS_PER_S * 1e3
    wg = plan.gather_weights(w).reshape(-1, O)
    gather = idx.long().reshape(-1)
    xqs = [fake_quant(x, spec, scale)[:, gather] for x in xs]

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

    lib = timed([lambda q=q: torch.matmul(q, wg) for q in xqs] * 4)
    calls = [lambda x=x: ops.pcilt_fused_gemv_plan(x, tabs, idx, spec,
                                                   scale, 2)
             for x in xs] * 4
    k = timed(calls, GEMV_SPLIT_KERNEL)
    d = timed(kept_design(ops, calls), GEMV_DIRECT_KERNEL)
    p = timed([lambda x=x: ops.gemv_plan_plain(x, tabs, idx, spec, scale, 2)
               for x in xs] * 2)
    rows["gemv_plan perm"] = {
        "kernel": "gemv_plan", "shape": [G, 256, O], "ms": k["ms"],
        "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
        "plain_ms": p["ms"], "plain_warm_ms": p["warm_ms"],
        "plain_shape": "the kernel's", "library_ms": lib["ms"],
        "library_warm_ms": lib["warm_ms"],
        "library_call": LIB_NOTE["gemv_plan"], "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": nbytes, "fetch_adds": B * G * O,
        "launches_per_projection": 1, "variant": "split",
        "direct_ms": d["ms"], "direct_warm_ms": d["warm_ms"]}
    log(f"time  {'gemv_plan':19s} {'gemv_plan perm':26s} kernel "
        f"{k['ms'] * 1e3:8.2f} us (warm {k['warm_ms'] * 1e3:8.2f})  kept "
        f"design {d['ms'] * 1e3:8.2f} us  plain "
        f"{p['ms'] * 1e3:9.2f} us  library {lib['ms'] * 1e3:8.2f} us  bound "
        f"{max(b_ms, o_ms) * 1e3:7.2f} us ({rows['gemv_plan perm']['bound_by']})"
        f"  x1/projection")

    # -- kernel 6 at the same shape, on the plan's packed offsets ([4, 512]:
    #    phase 10's path="kernel"), in the split design the chooser takes
    #    at decode-size M, beside its kept direct and staged designs forced
    #    and the same matmul
    offs = [plan_offsets(torch, x, plan, spec, scale) for x in xs]
    require(ops.gemv_host_variant(B, G, 256, O, 4) == "split",
            "kernel 6 at M = 4 is not the split design")
    nbytes = uniq * O * 4 + B * G * 4 + B * O * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    k = timed([lambda o=o: ops.pcilt_gemv(o, tabs) for o in offs] * 4,
              HOST_SPLIT_KERNEL)
    kept = {v: timed([lambda o=o: ops._gemv_host(o, tabs, variant=v)
                      for o in offs] * 4, name)
            for v, name in (("direct", HOST_DIRECT_KERNEL),
                            ("staged", HOST_STAGED_KERNEL))}
    p = timed([lambda o=o: ops.gemv_host_plain(o, tabs) for o in offs] * 2)
    rows["gemv_host plan M4"] = {
        "kernel": "gemv_host", "shape": [B, G, 256, O], "ms": k["ms"],
        "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
        "plain_ms": p["ms"], "plain_warm_ms": p["warm_ms"],
        "plain_shape": "the kernel's", "library_ms": lib["ms"],
        "library_warm_ms": lib["warm_ms"],
        "library_call": LIB_NOTE["gemv_plan"], "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": nbytes, "fetch_adds": B * G * O,
        "launches_per_projection": 1, "variant": "split",
        "direct_ms": kept["direct"]["ms"],
        "direct_warm_ms": kept["direct"]["warm_ms"],
        "staged_ms": kept["staged"]["ms"],
        "staged_warm_ms": kept["staged"]["warm_ms"]}
    log(f"time  {'gemv_host':19s} {'gemv_host plan M4':26s} kernel "
        f"{k['ms'] * 1e3:8.2f} us (warm {k['warm_ms'] * 1e3:8.2f}, the split "
        f"design)  kept direct {kept['direct']['ms'] * 1e3:8.2f} us  kept "
        f"staged {kept['staged']['ms'] * 1e3:8.2f} us  plain "
        f"{p['ms'] * 1e3:9.2f} us  library {lib['ms'] * 1e3:8.2f} us  bound "
        f"{max(b_ms, o_ms) * 1e3:7.2f} us")
    del tabs, w, wg, flush, offs


def paper_cnn_setup(torch):
    """The paper CNN at its published widths with seeded weights, per-layer
    scales from a dense forward over one seeded 1024x768 calibration image,
    and one seeded 1024x768 test image (values uniform in [0, 2))."""
    import numpy as np

    from repro_torch.configs.paper_cnn import config

    model = config()
    params = model.init_params(seed=0)
    rng = np.random.default_rng(12)

    def image():
        return torch.from_numpy(rng.uniform(0.0, 2.0, (1, *FULL_HW, 1))
                                .astype(np.float32)).cuda()

    with torch.no_grad():
        scales = model.calibrate(params, image())
    return model, params, scales, image()


def host_offsets(torch, xp, spec, scale, k, G, band=32):
    """The host-packed path's offsets ``[1, Ho, Wo, G]`` int32 of a padded
    image (group 1, stride 1), built ``band`` output rows at a time (the
    whole conv4 patch would take ~16 GB in float32 plus its packing
    temporaries)."""
    from repro_torch.core.lut_layers import conv_offsets

    Ho, Wo = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    off = torch.empty((1, Ho, Wo, G), dtype=torch.int32, device=xp.device)
    for y in range(0, Ho, band):
        y1 = min(Ho, y + band)
        off[:, y:y1] = conv_offsets(xp[:, y:y1 - 1 + k], spec, scale, 1, k,
                                    k, 1, "VALID")
    return off


def time_conv_kernels(torch, ops, report, rows):
    """Phase 4 for the conv kernels: each layer of the paper CNN at B = 1,
    1024x768, on its real input (the dense fake-quant chain of the seeded
    network): the wrapper's device time (padded input, so the call is the
    kernels alone: for the fused and shared conv the staged design's code
    pre-pass and fetch, two launches, summed), the kept design's forced
    beside it (``direct_ms``), the plain version's on the top-left 64x48
    crop (labelled ``plain_shape``), one library call, the bound and, for
    the conv kernels, the fetch floor: the fetch-adds' 4-byte cells over
    the SMs' shared-memory rate, 128 B a clock each at ``clocks.max.sm``."""
    import torch.nn.functional as F

    from repro_torch.core.lut_layers import conv_offsets, flatten_filters
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import fake_quant
    from repro_torch.core.serving import convert_conv_kernel
    from repro_torch.kernels.ref import pcilt_conv2d_ref, pcilt_gemv_ref
    from repro_torch.models.cnn import dm_conv2d

    model, params, scales, x = paper_cnn_setup(torch)
    spec, k = model.act_spec, model.k
    flush = L2Flush(torch)
    h, small = x, x[:, :SMALL_HW[0], :SMALL_HW[1]]

    def timed(calls, kernel=None, per_call=1):
        return time_calls(torch, calls, flush, kernel, reps=1, warmup=1,
                          retries=report["profile_retries"],
                          launches_per_call=per_call)

    def add(kernel, i, shape, kt, plain, lib, nbytes, ops_, direct=None):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops_ / F32_OPS_PER_S * 1e3
        key = f"{kernel} conv{i}"
        rows[key] = {"kernel": kernel, "shape": shape, "ms": kt["ms"],
                     "warm_ms": kt["warm_ms"], "events_ms": kt["events_ms"],
                     "plain_ms": plain["ms"],
                     "plain_shape": f"B1 {SMALL_HW[1]}x{SMALL_HW[0]} crop",
                     "library_ms": lib["ms"],
                     "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms > o_ms else "operations",
                     "fetch_adds": ops_, "bytes": nbytes,
                     "launches_per_forward": 1}
        extra = ""
        if direct is not None:
            floor = ops_ * 4 / (report["sm_count"] * SMEM_BYTES_PER_CLOCK
                                * report["sm_clock_max_mhz"] * 1e6) * 1e3
            rows[key].update(variant="staged", direct_ms=direct["ms"],
                             direct_warm_ms=direct["warm_ms"],
                             fetch_floor_ms=floor)
            extra = (f"  kept kernel {direct['ms']:10.3f} ms  fetch floor "
                     f"{floor:8.3f} ms")
        log(f"time  {kernel:13s} conv{i} {shape}  kernel "
            f"{kt['ms']:10.3f} ms (warm {kt['warm_ms']:10.3f})  plain "
            f"{plain['ms']:8.3f} ms at {SMALL_HW[1]}x{SMALL_HW[0]}  library "
            f"{lib['ms']:8.3f} ms  bound {max(b_ms, o_ms):8.3f} ms "
            f"({rows[key]['bound_by']}){extra}")

    with torch.no_grad():
        for i, (C, O) in enumerate(conv_layers(model)):
            name = f"conv{i}"
            w, s = params[name], scales[name]
            tabs = build_grouped_tables(flatten_filters(w, 1), spec, s, 1)
            layer = convert_conv_kernel(w, spec, s, 1, weight_bits=4,
                                        shared=True)
            pool, wq = layer.shared, layer.filters
            xp, xps = padded(h, k, 1), padded(small, k, 1)
            P, (G, V, _) = h.shape[1] * h.shape[2], tabs.shape
            shape = f"B1 {FULL_HW[1]}x{FULL_HW[0]} C{C} G{G} V{V} O{O}"
            fetch_adds = P * G * O
            out_bytes = P * O * 4
            xq = fake_quant(xp, spec, s).permute(0, 3, 1, 2).contiguous()
            w4 = w.permute(3, 2, 0, 1).contiguous()
            wq4 = wq.permute(3, 2, 0, 1).contiguous()
            require(ops.conv_variant(V, tabs.element_size()) == "staged",
                    f"{name}: the paper CNN's V = {V} is not staged")
            lib = timed([lambda: F.conv2d(xq, w4)])
            kt = timed([lambda: ops.pcilt_fused_conv2d(
                xp, tabs, spec, s, 1, k, k, padding="VALID")],
                STAGED_KERNELS, per_call=2)
            direct = timed([lambda: ops._fused_conv2d(
                xp, tabs, spec, s, 1, k, k, padding="VALID",
                variant="direct")], DIRECT_KERNEL)
            plain = timed([lambda: ops.fused_conv2d_plain(
                xps, tabs, spec, s, 1, k, k, 1)])
            add("fused_conv2d", i, shape, kt, plain, lib,
                xp.numel() * 4 + tabs.numel() * 4 + out_bytes, fetch_adds,
                direct)
            lib = timed([lambda: F.conv2d(xq, wq4)])
            kt = timed([lambda: ops.pcilt_shared_conv2d(
                xp, pool.pool, pool.seg_idx, spec, s, 1, k, k,
                padding="VALID")], STAGED_KERNELS, per_call=2)
            direct = timed([lambda: ops._shared_conv2d(
                xp, pool.pool, pool.seg_idx, spec, s, 1, k, k,
                padding="VALID", variant="direct")], DIRECT_KERNEL)
            plain = timed([lambda: ops.shared_conv2d_plain(
                xps, pool.pool, pool.seg_idx, spec, s, 1, k, k, 1)])
            add("shared_conv2d", i, shape + f" X{pool.pool.shape[0]}", kt,
                plain, lib, xp.numel() * 4 + pool.pool_bytes() + out_bytes,
                fetch_adds, direct)
            del xq, pool, layer
            # the host-packed kernels on the layer's offsets; their plain
            # versions (the ref fetch-sums) on the crop's offsets; the
            # library call on int64 indices (its 2-D form counts bags in
            # the index dtype: more than 2**31 of them at conv3 and conv4)
            off = host_offsets(torch, xp, spec, s, k, G)
            offs = conv_offsets(xps, spec, s, 1, k, k, 1, "VALID")
            host = {"gemv_host": (ops._gemv_host, pcilt_gemv_ref,
                                  off.view(-1, G), offs.view(-1, G))}
            if i == len(model.channels) - 1:  # the satellite, at conv4
                host["conv2d_host"] = (ops._conv2d_host, pcilt_conv2d_ref,
                                       off, offs)
            require(ops.gemv_host_variant(P, G, V, O, 4) == "staged",
                    f"{name}: the host-packed GEMV is not staged")
            kts = {n_: timed([lambda f=v[0], o=v[2]: f(o, tabs)],
                             HOST_STAGED_KERNEL) for n_, v in host.items()}
            kept = {n_: timed([lambda f=v[0], o=v[2]: f(o, tabs,
                                                        variant="direct")],
                              HOST_DIRECT_KERNEL) for n_, v in host.items()}
            plains = {n_: timed([lambda f=v[1], o=v[3]: f(o, tabs)])
                      for n_, v in host.items()}
            off_bytes = off.numel() * 4
            idx = off.view(-1, G).long()
            del off, host
            idx += torch.arange(G, device=idx.device) * V
            tab2d = tabs.view(G * V, O)
            for name_ in kts:  # one library call timed for each row
                lib = timed([lambda: F.embedding_bag(idx, tab2d, mode="sum")])
                add(name_, i, shape, kts[name_], plains[name_], lib,
                    off_bytes + tabs.numel() * 4 + out_bytes, fetch_adds,
                    kept[name_])
            del idx, offs, tab2d
            h = torch.relu(dm_conv2d(h, w, spec, s))
            small = h[:, :SMALL_HW[0], :SMALL_HW[1]]
            del tabs, xp
            torch.cuda.empty_cache()
    del flush


# ----------------------------------------------------------------------------
# phase 3 + 4: the CRC-32 kernel (the tables' integrity record and checks)
# ----------------------------------------------------------------------------


def crc_case(report, errs, what, got, want):
    """Record one CRC case (into ``errs`` too, when given): bit-equal or
    the script fails."""
    ok = got == want
    if errs is not None:
        errs["crc32"] = max(errs["crc32"], 0.0 if ok else 1.0)
    report["checks"].append({"kernel": "crc32", "case": what,
                             "max_abs_err": 0.0 if ok else 1.0,
                             "tol": "bit-equal", "ok": ok})
    log(f"check crc32         {what:44s} {got:#010x} vs zlib {want:#010x} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"crc32 {what}: the CRC kernel differs from zlib.crc32")


def crc_device_launches(torch, ops, call, report):
    """Device launches of one call of the CRC wrapper ``call``: the
    records of the CRC's kernels in a profile of that call alone (after a
    first call outside the window, which uploads its range rows), held to
    the launches the library reports making.  A profile that shows fewer
    (the profiler can lose records: ``scripts/profiler_window_probe.py``)
    is taken again, counted in ``profile_retries``, up to three times;
    then the script fails."""
    call()
    torch.cuda.synchronize()
    for attempt in range(3):
        before = ops.CRC_DEVICE_LAUNCHES["passes"]
        prof = _profile(torch, call)
        made = ops.CRC_DEVICE_LAUNCHES["passes"] - before
        rows = {k: c for k, (c, _) in prof.items()
                if any(n in k for n in CRC_KERNELS)}
        seen = sum(rows.values())
        if seen == made:
            return seen
        report["profile_retries"].append(
            {"kernel": "crc32", "launches_seen": seen, "of": made,
             "rows": {k[:48]: c for k, c in rows.items()}})
        log(f"  (crc profile {attempt + 1} saw {seen} of {made} device "
            f"launches: taken again; rows {rows})")
    raise SmokeFailure(f"the profiler recorded fewer CRC device launches "
                       f"of one call than the library made ({made}) three "
                       f"times")


def check_crc_kernel(torch, ops, report, errs):
    """Phase 3 for the CRC kernel, each case in both chunk-pass designs
    (``ops.CRC_VARIANTS``: the banked one and the kept one, forced): bit-equal
    to ``zlib.crc32`` on ragged lengths (0, 1, a staging step of 128
    bytes, a lane slice and a chunk +- 1, a few MB of seeded bytes: a
    length whose padded chunks are 16-byte aligned, staged after the
    first, and one whose are not), a continued CRC, several
    streams in one launch (ragged lengths at unaligned addresses, an empty
    one, ragged ranges of one tensor), a bfloat16 table and a strided layer
    of phase 7's segment-major wz stack ([192, 24, 256, 1536] float32: 192
    ranges); two launches bit-identical.  The bytes go to the host once,
    for zlib."""
    import zlib

    from repro_torch.core.pcilt import layer_checksum, table_checksum
    from repro_torch.kernels.ref import CRC_CHUNK_BYTES, CRC_LANE_BYTES

    designs = list(ops.CRC_VARIANTS)
    seen = dict(ops.CRC_VARIANT_LAUNCHES)

    def each(what, call, want):
        """``call()`` in every design, each held to ``want``; -> the
        results."""
        out = []
        for design in designs:
            with ops._crc_forced(design):
                got = call()
            crc_case(report, errs, f"{what} [{design}]", got, want)
            out.append(got)
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    data = torch.randint(0, 256, (5_000_011,), dtype=torch.uint8,
                         generator=gen, device=dev)
    host = data.cpu().numpy()
    for n in (0, 1, 127, 129, CRC_LANE_BYTES - 1, CRC_LANE_BYTES + 1,
              CRC_CHUNK_BYTES - 1, CRC_CHUNK_BYTES, CRC_CHUNK_BYTES + 1,
              4_999_936, 5_000_011):
        each(f"{n} bytes", lambda: ops.pcilt_crc32([data[:n]])[0],
             zlib.crc32(host[:n].tobytes()))
    each("3 MB from byte 3, continuing a CRC",
         lambda: table_checksum(data[3:3_000_003], crc=0xDEADBEEF),
         zlib.crc32(host[3:3_000_003].tobytes(), 0xDEADBEEF))
    cuts = [(5, 7), (12, CRC_CHUNK_BYTES), (CRC_CHUNK_BYTES + 12, 0),
            (CRC_CHUNK_BYTES + 12, 1), (CRC_CHUNK_BYTES + 13, 2_000_001)]
    starts = [3, 70_001, 9, 1_400_000]
    want = [zlib.crc32(host[a:a + n].tobytes()) for a, n in cuts] + [
        zlib.crc32(b"".join(host[a:a + CRC_CHUNK_BYTES + 1].tobytes()
                            for a in starts))]
    for design in designs:
        with ops._crc_forced(design):
            got = ops.pcilt_crc32([data[a:a + n] for a, n in cuts]
                                  + [(data, starts, CRC_CHUNK_BYTES + 1)])
        for i, (g, w) in enumerate(zip(got, want)):
            crc_case(report, errs,
                     f"6 streams in one launch, stream {i} [{design}]", g, w)
    t = (torch.randn(384, 256, 128, generator=gen, device=dev)
         .to(torch.bfloat16))
    want = zlib.crc32(t.cpu().view(torch.int16).numpy().tobytes())
    for first in each("bf16 [384, 256, 128]",
                      lambda: ops.pcilt_crc32([t])[0], want):
        each("bf16 [384, 256, 128], second launch",
             lambda: ops.pcilt_crc32([t])[0], first)
    del t
    stack = torch.randn(192, N_LAYERS, 256, 1536, generator=gen, device=dev)
    for l in (0, 17):
        want = zlib.crc32(stack[:, l].contiguous().cpu().numpy().tobytes())
        each(f"segment-major [192, 24, 256, 1536] l{l}",
             lambda: layer_checksum(stack, l, axis=1), want)
        each(f"segment-major l{l}, second launch",
             lambda: layer_checksum(stack, l, axis=1), want)
    del stack, data
    ran = {d: c - seen[d] for d, c in ops.CRC_VARIANT_LAUNCHES.items()}
    require(len(set(ran.values())) == 1 and min(ran.values()) > 0,
            f"the CRC cases ran the designs {ran}, not each alike")


def time_crc_kernel(torch, ops, report, rows, errs):
    """Phase 4 for the CRC kernel: one call over one full-width layer's
    tables (LAYER_TABLES: seven streams of one buffer, as the monitor's
    layer check makes them) and over the head pool's bytes
    (HEAD_POOL_BYTES), in each chunk-pass design (``ops.CRC_VARIANTS``,
    forced; ``ms`` is the default design's, ``kept_ms`` the kept one's), L2
    flushed before every call, each call's device launches counted by the
    profiler; beside the bytes bound at 3.35 TB/s and the host
    ``zlib.crc32`` time of the same bytes (the reference's function on the
    host; not a library kernel: torch has no CRC call, so ``library_ms`` is
    null); the plain version on 64 MiB of them.  Each result is held to
    zlib's."""
    from repro_torch.core.pcilt import table_checksum
    from repro_torch.kernels.ref import crc32_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    flush = L2Flush(torch)
    plain_n = 64 << 20
    default = next(iter(ops.CRC_VARIANTS))
    for key, sizes in (("crc32 layer", list(LAYER_TABLES.values())),
                       ("crc32 head", [HEAD_POOL_BYTES])):
        nbytes = sum(sizes)
        buf = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                            generator=gen, device=dev)
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        streams = [(buf, [a], n) for a, n in zip(starts, sizes)]
        host = buf.cpu()
        t0 = time.perf_counter()
        want = [table_checksum(host[a:a + n])  # zlib.crc32, 64 MiB a call
                for a, n in zip(starts, sizes)]
        zlib_s = time.perf_counter() - t0
        del host
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times = {}
        for design in ops.CRC_VARIANTS:
            def call(design=design):
                with ops._crc_forced(design):
                    return ops.pcilt_crc32(streams)

            per = crc_device_launches(torch, ops, call, report)
            k = time_calls(torch, [call] * 5, flush, kernel=CRC_KERNELS,
                           launches_per_call=per,
                           retries=report["profile_retries"])
            times[design] = dict(k, launches=per)
            for i, (g, w) in enumerate(zip(call(), want)):
                crc_case(report, errs, f"{key} stream {i} ({sizes[i]} "
                         f"bytes) [{design}]", g, w)
            log(f"time  crc32 {design:7s} {key:26s} kernel {k['ms']:9.3f} "
                f"ms (warm {k['warm_ms']:9.3f}, events "
                f"{k['events_ms']:9.3f}; {per} device launches, profiled)"
                f"  bound {bound:7.3f} ms ({bound / k['ms']:.0%} of it)")
        p = time_calls(torch, [lambda: crc32_plain([buf[:plain_n]])], flush,
                       reps=1, warmup=1, retries=report["profile_retries"])
        del buf
        k = times[default]
        rows[key] = {"kernel": "crc32", "shape": sizes, "ms": k["ms"],
                     "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
                     "design": default, "kept_ms": times["kept"]["ms"],
                     "designs": times,
                     "plain_ms": p["ms"], "plain_shape": [plain_n],
                     "library_ms": None, "library_call": LIB_NOTE["crc32"],
                     "host_zlib_ms": zlib_s * 1e3, "bound_ms": bound,
                     "bound_by": "bytes",
                     "device_launches_per_call": k["launches"]}
        log(f"time  crc32         {key:26s} {default} {k['ms']:9.3f} ms, "
            f"kept {times['kept']['ms']:9.3f} ms  bound {bound:7.3f} ms  "
            f"host zlib.crc32 (the reference's function) "
            f"{zlib_s * 1e3:10.1f} ms  plain {p['ms']:8.2f} ms at 64 MiB")
    del flush


# ----------------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------------


def watch_monitor(eng):
    """Host seconds of ``eng``'s monitor: each ``HealthMonitor.on_tick``,
    each layer check and each head check (each ends in a CRC read back, so
    the clock covers the device work), and each tick's span from the start
    of its decode step to the end of its ``on_tick``: the step and the
    monitor measured as one span."""
    times = {"tick": [], "head": [], "layer": [], "span": []}
    mon, dec = eng.monitor, eng.pdecode
    started = [0.0]
    step, on_tick = eng._step, mon.on_tick

    def timed_step():
        started[0] = time.perf_counter()
        return step()

    def tick(*a, **k):
        t0 = time.perf_counter()
        out = on_tick(*a, **k)
        t1 = time.perf_counter()
        times["tick"].append(t1 - t0)
        times["span"].append(t1 - started[0])
        return out

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    eng._step = timed_step
    mon.on_tick = tick
    dec.verify_head = timed(dec.verify_head, "head")
    dec.verify_layer = timed(dec.verify_layer, "layer")
    return times


def monitor_summary(eng, stats, launches, times, med_step, what):
    """The monitored run's health: no event, no rollback, no restart; its
    CRC launches a tick (every one in the CRC's default design) and
    seconds a tick, a layer check and a head check, the median step (the
    monitor outside it) and the median span of a decode step and its
    monitor tick, measured together."""
    from repro_torch.kernels import ops

    designs = {d: n for d, n in ops.CRC_VARIANT_LAUNCHES.items() if n}
    require(list(designs) == [next(iter(ops.CRC_VARIANTS))],
            f"{what}: the monitor's CRCs ran the designs {designs}")
    events = stats["health_events"]
    require(events == [] and stats["rollbacks"] == 0
            and stats["restarts"] == 0,
            f"{what}: the monitor reported {events}, {stats['rollbacks']} "
            f"rollbacks, {stats['restarts']} restarts on clean tables")
    ticks = len(times["tick"])
    crc = launches.get("crc32", 0)
    med = {k: statistics.median(v) if v else None for k, v in times.items()}
    out = {"health_events": events, "rollbacks": stats["rollbacks"],
           "ticks_checked": ticks, "crc_launches": crc,
           "crc_designs": designs,
           "crc_launches_per_tick": crc / max(ticks, 1),
           "head_checks": len(times["head"]),
           "monitor_s_per_tick": med["tick"], "layer_check_s": med["layer"],
           "head_check_s": med["head"], "monitor_tick_seconds": times["tick"],
           "head_check_seconds": times["head"], "median_step_s": med_step,
           "median_step_with_monitor_s": med["span"],
           "step_with_monitor_seconds": times["span"]}
    log(f"{what} monitor: {ticks} ticks checked, {crc} CRC launches "
        f"({crc / max(ticks, 1):.2f} a tick), median {med['tick'] * 1e3:.2f} "
        f"ms a tick (a layer's CRC {med['layer'] * 1e3:.2f} ms), "
        f"{len(times['head'])} head check(s) at "
        + ", ".join(f"{t * 1e3:.2f}" for t in times["head"])
        + f" ms; median step {med_step * 1e3:.2f} ms (the monitor outside "
        f"it), median decode step and monitor tick as one span "
        f"{med['span'] * 1e3:.2f} ms; no health event, no rollback")
    return out


def allocator_counts(torch):
    """The caching allocator's cumulative counts on the card: device
    allocations (``cudaMalloc``) and retries after freeing its cache."""
    st = torch.cuda.memory_stats()
    return {"device_allocs": st.get("num_device_alloc"),
            "alloc_retries": st.get("num_alloc_retries")}


def allocator_delta(torch, before):
    now = allocator_counts(torch)
    return {k: (None if now[k] is None or before[k] is None
                else now[k] - before[k]) for k in now}


def sentinel_runs(cfg, eng, times, pairs=3):
    """The phase-5 engine served again on the same requests with its
    saturation sentinel off and on, ``pairs`` pairs in this one process,
    the side that runs first alternating: each run's median step and
    median span of a decode step and its monitor tick, and the caching
    allocator's counts, so that the counters' cost and the run-to-run
    spread of the host-bound step show side by side."""
    import torch

    from repro_torch.launch.serve import make_requests

    out = []
    for i in range(2 * pairs):
        eng.sentinel = (i % 2 == 1) != (i // 2 % 2 == 1)
        for k in times:
            times[k] = []
        n0 = len(eng.step_seconds)
        alloc = allocator_counts(torch)
        stats = eng.run(make_requests(cfg, 4, 8, seed=0))
        require(stats["health_events"] == [] and stats["rollbacks"] == 0,
                f"sentinel run {i}: {stats['health_events']}")
        out.append({"sentinel": eng.sentinel,
                    "allocator": allocator_delta(torch, alloc),
                    "median_step_s": statistics.median(
                        eng.step_seconds[n0:]),
                    "median_step_with_monitor_s": statistics.median(
                        times["span"]),
                    "monitor_s_per_tick": statistics.median(times["tick"])})
        log(f"engine again, sentinel {'on ' if eng.sentinel else 'off'}: "
            f"median step {out[-1]['median_step_s'] * 1e3:.2f} ms, step and "
            f"monitor tick {out[-1]['median_step_with_monitor_s'] * 1e3:.2f}"
            f" ms, monitor {out[-1]['monitor_s_per_tick'] * 1e3:.2f} ms; "
            f"allocator {out[-1]['allocator']}")
    eng.sentinel = True
    for on in (False, True):
        med = statistics.median(r["median_step_s"] for r in out
                                if r["sentinel"] == on)
        log(f"sentinel {'on ' if on else 'off'}: median of the runs' median "
            f"steps {med * 1e3:.2f} ms over {pairs} runs")
    return out


def crc_real_tables(torch, report, pcilt, layer, paired=False):
    """The CRC kernel against ``zlib.crc32`` on the bundle's real tables:
    layer ``layer`` of the conv stack and of every projection stack (a
    strided slice when ``paired``) in one call, as the monitor's layer
    check makes it, and the head pool and pointers in another, as its head
    check; each table copied to the host once for zlib."""
    import zlib

    from repro_torch.core.pcilt import checksums

    def zl(t):
        t = t.contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return zlib.crc32(t.numpy().tobytes())

    tabs = {"conv": (pcilt["tables"], 0)}
    tabs.update({k: (t, 1 if paired else 0)
                 for k, t in pcilt["proj"]["tables"].items()})
    got = checksums([(t, layer, axis) for t, axis in tabs.values()])
    for (name, (t, axis)), crc in zip(tabs.items(), got):
        sl = t[:, layer] if axis else t[layer]
        crc_case(report, None, f"{name} layer {layer} {list(sl.shape)}",
                 crc, zl(sl))
    head = pcilt["head"]
    got = checksums([head["pool"], head["seg_idx"]])
    for name, crc in zip(("pool", "seg_idx"), got):
        crc_case(report, None, f"head {name} {list(head[name].shape)}",
                 crc, zl(head[name]))


def serve(torch, ops, report):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.launch.serve import Engine, make_requests

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    d_inner = 2 * cfg.d_model
    G_in, V = cfg.d_model // 2, 256
    proj_cells = cfg.n_layers * V * (
        G_in * (2 * d_inner + 2 * cfg.ssm.d_state + d_inner // 64)
        + (d_inner // 2) * cfg.d_model)
    conv_bytes = cfg.n_layers * (d_inner + 2 * cfg.ssm.d_state) * (1 << 16) * 4
    head_bytes = G_in * V * cfg.padded_vocab * 4  # 384 distinct segments
    free, total = torch.cuda.mem_get_info()
    need = proj_cells * 4 + conv_bytes + head_bytes
    log(f"tables: {need / 2**30:.1f} GiB in float32 against "
        f"{free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB")
    require(need + (3 << 30) <= free,
            f"the card has {free / 2**30:.1f} GiB free; the float32 tables "
            f"need {need / 2**30:.1f} GiB plus ~2 GiB of working memory")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=B, pcilt=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    conv = dict(eng.convert_timings)
    head = eng.pdecode.pcilt["head"]
    head_bytes = head["pool"].numel() * head["pool"].element_size()
    log(f"engine: set-up {setup_s:.1f} s; conversion "
        + ", ".join(f"{k} {v:.1f}" for k, v in conv.items())
        + f"; table bytes (conv + projection stacks) "
        f"{eng.pdecode.table_bytes() / 2**30:.2f} GiB")
    log(f"head pool bytes: {head_bytes} ({head_bytes / 2**30:.2f} GiB, "
        f"{head['pool'].shape[0]} segments)")
    reqs = make_requests(cfg, 4, 8, seed=0)
    times = watch_monitor(eng)
    alloc = allocator_counts(torch)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    alloc = allocator_delta(torch, alloc)
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    # the monitor's CRC launches are counted apart from the step's kernels
    per_step = {k: v / steps for k, v in launches.items() if k != "crc32"}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(eng.step_seconds)
    gen_tokens = sum(len(r.out) for r in reqs)
    log(f"served {stats['served']}/{len(reqs)} requests: {steps} steps "
        f"({stats['prefill_ticks']} prefill, {stats['decode_ticks']} decode) "
        f"in {stats['wall_s']:.2f} s; median step {med * 1e3:.2f} ms "
        f"({B / med:.1f} tokens/s over {B} slots; {gen_tokens} generated "
        f"tokens at {gen_tokens / stats['wall_s']:.1f} tokens/s end to end)")
    log(f"median step with an empty design cache {med * 1e3:.2f} ms (before "
        f"the cache, 28.56-49.36 ms on this card); design dispatch: "
        f"{memo_microbench(torch, ops)}")
    log(f"peak memory allocated {peak / 2**30:.2f} GiB (tables, the "
        f"checkpoint ring of {eng.ckpts.maxlen} cache copies and the step);"
        f" allocator in the run: {alloc}")
    log("launches per step: " + ", ".join(f"{k} {v:g}"
                                          for k, v in per_step.items()))
    monitor = monitor_summary(eng, stats, launches, times, med,
                              "engine")
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == len(reqs), "not every request was served")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), "generated tokens out of range")
    require(per_step == {"gemv_stacked": 144, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"main path did not run through the kernels: {per_step}")
    designs = dict(ops.GEMV_VARIANT_LAUNCHES)
    require(designs == {"split": launches["gemv_stacked"], "staged": 0,
                        "direct": 0},
            f"the main path's fused GEMVs ran the designs {designs}")
    head_d = dict(ops.SHARED_GEMV_VARIANT_LAUNCHES)
    require(head_d == {"split": launches["shared_gemv"], "direct": 0},
            f"the main path's head ran the designs {head_d}")
    dw_d = dict(ops.DWCONV_VARIANT_LAUNCHES)
    require(dw_d == {"tiled": launches["dwconv1d"], "direct": 0},
            f"the main path's dwconv ran the designs {dw_d}")
    report["serve"] = {"setup_s": setup_s, "convert": conv,
                       "peak_bytes": peak, "steps": steps,
                       "median_step_s": med, "step_seconds": eng.step_seconds,
                       "wall_s": stats["wall_s"], "tokens": gen_tokens,
                       "launches": launches, "launches_per_step": per_step,
                       "table_bytes": eng.pdecode.table_bytes(),
                       "head_pool_bytes": head_bytes,
                       "outputs": [r.out for r in reqs],
                       "gemv_designs": designs, "head_designs": head_d,
                       "dwconv_designs": dw_d, "monitor": monitor,
                       "allocator": alloc,
                       "ring_snapshots": eng.ckpts.maxlen}
    crc_real_tables(torch, report, eng.pdecode.pcilt, 0)
    oracle_check(torch, ops, eng, report)
    # a MambaLM.prefill cache of a 16-token prompt, fed to the PCILT step
    prompt = torch.randint(0, cfg.vocab, (B, PREFILL_PROMPT),
                           generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        logits, cache = eng.model.prefill(eng.params,
                                          {"tokens": prompt.cuda()})
    require({k: tuple(t.shape) for k, t in cache["layers"].items()}
            == {k: tuple(t.shape) for k, t in eng.cache["layers"].items()},
            "the prefill cache's shapes differ from the decode cache's")
    log(f"MambaLM.prefill of a {PREFILL_PROMPT}-token prompt at B = {B}: "
        f"its cache through the PCILT step, against the oracle")
    oracle_check(torch, ops, eng, report, key="oracle_after_prefill",
                 cache=cache, tok=logits.argmax(-1)[:, None])
    gen = torch.Generator(device="cuda").manual_seed(9)
    cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                       device="cuda") * 0.1
                        for k, t in eng.cache["layers"].items()}}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    report["serve"]["step_compare"] = step_compare(
        torch, ops, eng.model, eng.params, cache, tok,
        {"unpaired": eng.pdecode.pcilt},
        {"unpaired": {"gemv_stacked": 144, "dwconv1d": 24, "shared_gemv": 1}})
    monitor["sentinel_runs"] = sentinel_runs(cfg, eng, times)
    return launches


def memo_microbench(torch, ops, n=10 ** 4):
    """Host microseconds a call of the design dispatch takes for wz's
    stacked GEMV at B = 4 (its key's tuple built, then the memo's answer,
    as a launch does): with a memoised cache hit, with a memoised
    heuristic (the empty cache), and ``gemv_variant``'s ``lru_cache`` hit
    beside them; ``n`` calls each."""
    from repro_torch.kernels import autotune as atn

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.empty((B, 768), device=dev)

    def dispatch():
        key = ops._gemv_key("fused_gemv_stacked", False, ops._STACKED_DIMS,
                            x.shape[0], x.shape[0], 24, 384, 256, 1536, 2, 4)
        return ops._choose(key, dev, torch.float32,
                           lambda: ops.gemv_candidates(B, 384, 1536, 4),
                           None, None)

    res = {}
    key = ops._gemv_key("fused_gemv_stacked", False, ops._STACKED_DIMS, B, B,
                        24, 384, 256, 1536, 2, 4)
    mkey = (key[0], dev, torch.float32, key[2])
    for what, entry in (("hit", ("split", True)),
                        ("heuristic", ("split", False))):
        atn.MEMO[mkey] = entry
        dispatch()
        t0 = time.perf_counter()
        for _ in range(n):
            dispatch()
        res[what] = (time.perf_counter() - t0) / n * 1e6
    atn.MEMO.pop(mkey)
    t0 = time.perf_counter()
    for _ in range(n):
        ops.gemv_variant(B, 384, 1536, 4)
    res["gemv_variant"] = (time.perf_counter() - t0) / n * 1e6
    return ", ".join(f"{k} {v:.3f} us" for k, v in res.items()) \
        + f" a call ({n} calls)"


def oracle_check(torch, ops, eng, report, key="oracle", cache=None,
                 tok=None):
    """One decode step through the kernels against the dense fake-quant
    oracle on the same state (seeded random state and tokens, or the given
    ``cache`` and ``tok``): every layer and the head demoted, so each
    projection is a float32 matmul on fake-quantized inputs, each conv an
    einsum on the fake-quantized window and the head ``fake_quant(x) @
    kernel_q``; the oracle's step launches no kernel.  The fetch is exact on
    the grid, so the two differ by float32 summation order (and any
    quantization code that order tips over a rounding boundary downstream):
    allclose at 1e-3 relative to the largest logit, and argmax-equal
    wherever the oracle's top two logits are further apart than that
    tolerance (the head's logits lie on a coarse grid and can tie)."""
    if cache is None:
        gen = torch.Generator(device="cuda").manual_seed(5)
        cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                           device="cuda") * 0.1
                            for k, t in eng.cache["layers"].items()}}
        tok = torch.randint(0, eng.cfg.vocab, (B, 1), generator=gen,
                            device="cuda")
    bundle = eng.pdecode.pcilt
    with torch.no_grad():
        got, _ = eng.model.decode_step(eng.params, cache, tok, pcilt=bundle)
        before = dict(ops.LAUNCHES)
        want, _ = eng.model.decode_step(
            eng.params, cache, tok, pcilt=bundle,
            layer_ok=[False] * eng.cfg.n_layers, head_ok=False)
    require(dict(ops.LAUNCHES) == before,
            "the dense oracle's step launched a kernel")
    V = eng.cfg.vocab
    got, want = got[:, :V].float(), want[:, :V].float()
    tol = 1e-3 * float(want.abs().max())
    err = float((got - want).abs().max())
    top2 = want.topk(2, -1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    agree = got.argmax(-1) == want.argmax(-1)
    tie_ok = want.gather(1, got.argmax(-1, keepdim=True))[:, 0] >= \
        top2[:, 0] - tol
    log(f"oracle: max |logit - oracle| {err:.3e} (tol {tol:.3e}, max |logit| "
        f"{float(want.abs().max()):.3f}); argmax equal on "
        f"{int(agree.sum())}/{B} rows, near-ties {int((~decided).sum())}")
    report[key] = {"max_abs_err": err, "tol": tol,
                   "argmax_equal": int(agree.sum()),
                   "near_ties": int((~decided).sum())}
    require(bool(torch.isfinite(got).all()), "non-finite logits")
    require(err <= tol, "decode step disagrees with the dense oracle")
    require(bool((agree | (~decided & tie_ok)).all()),
            "greedy token differs from the dense oracle's")


# ----------------------------------------------------------------------------
# phase 6: the paper CNN
# ----------------------------------------------------------------------------


def _logits_check(torch, what, got, want, report_key, report):
    """End-to-end logits against the direct-multiplication oracle: allclose
    at rtol = atol = 1e-3 (``tests/test_system.py``'s tolerance), argmax
    equal."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3))
    agree = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"oracle {what}: max |logit - dm| {err:.3e} (max |logit| "
        f"{float(want.abs().max()):.3f}, rtol = atol = 1e-3), argmax "
        f"{'equal' if agree else 'DIFFERS'}")
    report[report_key] = {"max_abs_err": err, "allclose": ok,
                          "argmax_equal": agree, "logits": got.tolist(),
                          "oracle": want.tolist()}
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    require(ok, f"{what}: logits disagree with direct multiplication")
    require(agree, f"{what}: argmax differs from direct multiplication")


def _run_layers(torch, layers, params, x, conv):
    """The CNN's forward over per-layer callables ``conv(layer, h)``: conv,
    ReLU, global mean pool, head matmul."""
    h = x
    for layer in layers:
        h = torch.relu(conv(layer, h))
    return torch.matmul(h.float().mean(dim=(1, 2)), params["head"])


def paper_cnn(torch, ops, report):
    """The paper CNN at its published widths on one 1024x768 image, through
    ``forward(mode="fused")``, the extension-3 network of
    ``convert_conv_kernel(shared=True, weight_bits=4)`` layers, and
    ``forward(mode="kernel")`` on a 256x192 image; each path's launches
    are counted from 0 and must be 5.  Returns the launch counts."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.serving import convert_conv_kernel
    from repro_torch.models.cnn import dm_conv2d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, params, scales, x = paper_cnn_setup(torch)
    spec, k, L = model.act_spec, model.k, len(model.channels)
    out = {"scales": scales}
    launches = {}

    def counted(kernel, fn):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: c for n, c in ops.LAUNCHES.items() if c}
        log(f"  launches: {got}")
        require(got == {kernel: L},
                f"{kernel} path did not run through its kernel {L} times: "
                f"{got}")
        launches[kernel] = L
        return res, secs

    def variant_of(fn):
        """``fn()`` and the conv design that served it."""
        seen = dict(ops.CONV_VARIANT_LAUNCHES)
        res = fn()
        ran = [v for v, c in ops.CONV_VARIANT_LAUNCHES.items()
               if c != seen[v]]
        require(len(ran) == 1, f"one conv call ran {ran}")
        return res, ran[0]

    with torch.no_grad():
        t0 = time.perf_counter()
        tables = model.build_tables(params, scales)
        torch.cuda.synchronize()
        tbytes = sum(t.numel() * t.element_size() for t in tables.values())
        out["build_s"], out["table_bytes"] = time.perf_counter() - t0, tbytes
        log(f"paper CNN {model.channels}, {k}x{k}, INT{spec.bits}: tables "
            f"{tbytes / 2**30:.2f} GiB built in {out['build_s']:.2f} s; "
            + ", ".join(f"{n} {t.numel() / 1e6:.1f} M cells"
                        for n, t in tables.items()))
        require(tbytes == 688_960_000 * 4, "table bytes differ from the "
                "published widths' 688,960,000 float32 cells")

        # extrapolate from a 256x192 forward before the full-size one
        xs = x[:, :KERNEL_HW[0], :KERNEL_HW[1]].contiguous()
        model.forward(params, xs, mode="fused", scales=scales, tables=tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, xs, mode="fused", scales=scales, tables=tables)
        torch.cuda.synchronize()
        small_s = time.perf_counter() - t0
        est = small_s * FULL_HW[0] * FULL_HW[1] / (KERNEL_HW[0]
                                                   * KERNEL_HW[1])
        log(f"fused forward {KERNEL_HW[1]}x{KERNEL_HW[0]}: {small_s:.3f} s, "
            f"so ~{est:.1f} s at {FULL_HW[1]}x{FULL_HW[0]}")
        out["fused_small_s"], out["fused_est_s"] = small_s, est
        require(est < 60, f"a full-size forward would take ~{est:.0f} s")

        log(f"fused forward, {FULL_HW[1]}x{FULL_HW[0]}:")
        logits, secs = counted("fused_conv2d", lambda: model.forward(
            params, x, mode="fused", scales=scales, tables=tables))
        out["fused"] = {"forward_s": secs, "images_per_s": 1 / secs}
        log(f"  forward {secs * 1e3:.1f} ms, {1 / secs:.3f} images/s")

        # per layer on the same input: the kernel's device time, its output
        # against F.conv2d on the fake-quantized padded input, and the codes
        # that flipped between the PCILT chain and the DM chain
        hp = hd = x
        per_layer = []
        for i in range(L):
            name = f"conv{i}"
            w, s = params[name], scales[name]
            flips = int((quantize(hp, spec, s) != quantize(hd, spec, s)).sum())
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            got, variant = variant_of(lambda: ops.pcilt_fused_conv2d(
                hp, tables[name], spec, s, 1, k, k))
            ev1.record()
            ev1.synchronize()
            want = dm_conv2d(hp, w, spec, s)
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max())
            per_layer.append({"layer": name, "ms": ev0.elapsed_time(ev1),
                              "variant": variant,
                              "max_abs_err": err, "tol": tol,
                              "codes_flipped": flips,
                              "codes": hp.numel()})
            log(f"  {name}: {per_layer[-1]['ms']:9.3f} ms ({variant}); "
                f"|conv - dm| "
                f"{err:.3e} (tol {tol:.3e} = 1e-4 max|dm|: float32 sums "
                f"of up to 5000 products in another order); input codes "
                f"flipped vs the DM chain {flips} of {hp.numel()}")
            require(err <= tol, f"{name}: PCILT conv disagrees with F.conv2d")
            hp, hd = torch.relu(got), torch.relu(dm_conv2d(hd, w, spec, s))
        out["fused"]["layers"] = per_layer
        dm = model.forward(params, x, mode="dm", scales=scales)
        _logits_check(torch, f"fused {FULL_HW[1]}x{FULL_HW[0]}", logits, dm,
                      "fused_oracle", out)

        log("extension-3 network (convert_conv_kernel(shared=True, "
            f"weight_bits=4) per layer), {FULL_HW[1]}x{FULL_HW[0]}:")
        convs = [convert_conv_kernel(params[f"conv{i}"], spec,
                                     scales[f"conv{i}"], 1, weight_bits=4,
                                     shared=True) for i in range(L)]
        out["shared"] = {"pools": [
            {"X": c.shared.pool_cardinality, "G": c.n_segments,
             "pool_bytes": c.table_bytes()} for c in convs]}
        for i, p in enumerate(out["shared"]["pools"]):
            log(f"  conv{i}: X {p['X']} of G {p['G']} segments, pool "
                f"{p['pool_bytes'] / 2**20:.1f} MiB")
        served = []

        def shared_layer(c, h):
            res, variant = variant_of(lambda: c(h, path="shared"))
            served.append(variant)
            return res

        logits, secs = counted("shared_conv2d", lambda: _run_layers(
            torch, convs, params, x, shared_layer))
        out["shared"].update(forward_s=secs, images_per_s=1 / secs,
                             variants=served)
        log(f"  forward {secs * 1e3:.1f} ms, {1 / secs:.3f} images/s; "
            f"designs per layer {served}")
        dm = _run_layers(torch, convs, params, x,
                         lambda c, h: dm_conv2d(h, c.filters, spec, c.scale))
        _logits_check(torch, f"shared {FULL_HW[1]}x{FULL_HW[0]}", logits, dm,
                      "shared_oracle", out)
        del convs

        log(f"host-packed forward (mode='kernel'), {KERNEL_HW[1]}x"
            f"{KERNEL_HW[0]} (at full size its patches and offsets would "
            f"take ~31 GB):")
        logits, secs = counted("gemv_host", lambda: model.forward(
            params, xs, mode="kernel", scales=scales, tables=tables))
        host_d = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
        out["kernel"] = {"forward_s": secs, "image": list(KERNEL_HW),
                         "designs": host_d}
        log(f"  forward {secs * 1e3:.1f} ms; designs {host_d}")
        require(host_d == {"split": 0, "staged": L, "direct": 0},
                f"the host-packed forward ran kernel 6's designs {host_d}")
        dm = model.forward(params, xs, mode="dm", scales=scales)
        _logits_check(torch, f"kernel {KERNEL_HW[1]}x{KERNEL_HW[0]}", logits,
                      dm, "kernel_oracle", out)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"paper CNN peak memory allocated {out['peak_bytes'] / 2**30:.2f} GiB")
    report["paper_cnn"] = out
    return launches


# ----------------------------------------------------------------------------
# phase 7: paired (TL1) decode at full width
# ----------------------------------------------------------------------------


def _step_times(torch, ops, step, reps=3):
    """Median host seconds of ``reps`` synchronised calls of ``step`` (after
    one warm call), the launches of one call (with the fused GEMV designs
    that served them under ``"designs"``, the head's under
    ``"head_designs"``, the dwconv's under ``"dwconv_designs"``), and the
    device time and device kernel launches of one call (the sums of its
    kernels' profiler device times and counts)."""
    step()
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ops.reset_launches()
    step()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    designs = {k: v for k, v in ops.GEMV_VARIANT_LAUNCHES.items() if v}
    if designs:
        launches["designs"] = designs
    head = {k: v for k, v in ops.SHARED_GEMV_VARIANT_LAUNCHES.items() if v}
    if head:
        launches["head_designs"] = head
    dw = {k: v for k, v in ops.DWCONV_VARIANT_LAUNCHES.items() if v}
    if dw:
        launches["dwconv_designs"] = dw
    prof = _profile(torch, step)
    dev_us = sum(t for _, t in prof.values())
    dev_launches = sum(c for c, _ in prof.values())
    return statistics.median(secs), launches, dev_us / 1e6, dev_launches


def step_compare(torch, ops, model, params, cache, tok, variants, want):
    """The decode step at B = 4 for each ``variants`` bundle (None: dense),
    and, for each PCILT bundle, again with the kept fused GEMV design
    forced (``"<name> kept"``), then with the saturation counters on, as
    the engine's sentinel runs it (``"<name> stats"``), and so with the
    kept dwconv design forced (``"<name> stats kept dwconv"``, which
    zeroes its stats before each of its launches): median host seconds,
    launches, device time and device launches, the launches held to
    ``want``."""
    cmp, steps = {}, {}

    def device_launches(key):
        return sum(c for c, _ in _profile(torch, steps[key]).values())

    with torch.no_grad():
        for name, pc in variants.items():
            for kept in ((None, "gemv", "stats", "dwconv") if pc is not None
                         else (None,)):
                def step(pc=pc, kept=kept):
                    force = {"gemv": ops._gemv_forced("direct"),
                             "dwconv": ops._dwconv_forced("direct")}.get(
                                 kept, contextlib.nullcontext())
                    stats = {"with_stats": True} \
                        if kept in ("stats", "dwconv") else {}
                    with force:
                        return model.decode_step(params, cache, tok, pcilt=pc,
                                                 **stats)

                s, ln, dev_s, dev_n = _step_times(torch, ops, step)
                key = {None: name, "gemv": f"{name} kept",
                       "stats": f"{name} stats",
                       "dwconv": f"{name} stats kept dwconv"}[kept]
                steps[key] = step
                cmp[key] = {"median_step_s": s, "launches": ln,
                            "device_s": dev_s, "device_share": dev_s / s,
                            "device_launches": dev_n}
                log(f"step B{B} {key:26s}: median {s * 1e3:8.2f} ms, device "
                    f"time {dev_s * 1e3:7.2f} ms ({100 * dev_s / s:5.1f}% "
                    f"busy) in {dev_n} device launches, launches {ln}")
                expect = dict(want[name])
                gemvs = sum(v for k, v in expect.items()
                            if k in GEMV_LAUNCHES)
                if gemvs:
                    expect["designs"] = {
                        "direct" if kept == "gemv" else "split": gemvs}
                if expect.get("shared_gemv"):
                    expect["head_designs"] = {"split": expect["shared_gemv"]}
                if expect.get("dwconv1d"):
                    expect["dwconv_designs"] = {
                        "direct" if kept == "dwconv" else "tiled":
                            expect["dwconv1d"]}
                require(ln == expect, f"{key} step launches {ln}, not "
                        f"{expect}")
            if pc is not None:  # a profile that lost a record is taken again
                extra = cmp[f"{name} stats kept dwconv"]["device_launches"] \
                    - cmp[f"{name} stats"]["device_launches"]
                for _ in range(2):
                    if extra == want[name]["dwconv1d"]:
                        break
                    extra = device_launches(f"{name} stats kept dwconv") \
                        - device_launches(f"{name} stats")
                cmp[f"{name} stats"]["device_launches_saved"] = extra
                log(f"step B{B} {name}: the tiled dwconv saves {extra} device "
                    f"launches a step (the kept design's stats fills)")
                require(extra == want[name]["dwconv1d"],
                        f"{name}: the kept dwconv adds {extra} device launches"
                        f" a step, not {want[name]['dwconv1d']}")
    return cmp


def serve_paired(torch, ops, report):
    """Paired decode at full width and depth: mamba2-130m,
    ``PCILTConfig(act_bits=2, group=2)``, float32 tables, shared-pool head,
    converted by ``convert_mamba_decode(paired=True)`` and served by
    ``Engine(pcilt_bundle=...)`` (4 slots, 4 requests of 8 new tokens,
    sentinel counters on); then the median of three decode steps at B = 4,
    dense, unpaired (kernel 1) and paired (kernel 8), and one step against
    the dense fake-quant oracle.  Returns the path's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=2, group=2),
                              dtype=torch.float32)
    out = {"config": "mamba2-130m, act_bits 2, group 2, float32, paired, "
                     "head shared"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, device="cuda")
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    conv = {}
    t0 = time.perf_counter()
    dec = convert_mamba_decode(model, params, calib, paired=True,
                               head="shared", timings=conv, device="cuda")
    conv["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=B, pcilt=True, params=params,
                 pcilt_bundle=dec.pcilt, device="cuda")
    torch.cuda.synchronize()
    conv["engine_load_verify_s"] = time.perf_counter() - t0
    proj = dec.pcilt["proj"]
    head = dec.pcilt["head"]
    tbytes = dec.table_bytes()
    head_bytes = head["pool"].numel() * head["pool"].element_size()
    shapes = {k: list(t.shape) for k, t in proj["tables"].items()}
    log("paired conversion: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in conv.items()))
    log(f"paired tables (conv + projection stacks): {tbytes / 2**30:.2f} GiB;"
        f" segment-major stacks {shapes}")
    log(f"head pool bytes: {head_bytes} ({head_bytes / 2**30:.2f} GiB, "
        f"{head['pool'].shape[0]} segments)")
    require(proj["paired"] and all(s[1] == cfg.n_layers and s[2] == 256
                                   for s in shapes.values()),
            f"not segment-major paired stacks: {shapes}")

    reqs = make_requests(cfg, 4, 8, seed=0)
    times = watch_monitor(eng)
    alloc = allocator_counts(torch)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    alloc = allocator_delta(torch, alloc)
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    per_step = {k: v / steps for k, v in launches.items() if k != "crc32"}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(eng.step_seconds)
    monitor = monitor_summary(eng, stats, launches, times, med,
                              "paired engine")
    require(launches.get("crc32", 0) > 0,
            "the paired engine's monitor launched no CRC")
    log(f"paired: served {stats['served']}/{len(reqs)} requests, {steps} "
        f"steps in {stats['wall_s']:.2f} s; median step {med * 1e3:.2f} ms "
        f"({B / med:.1f} tokens/s over {B} slots); peak memory allocated "
        f"{peak / 2**30:.2f} GiB; allocator in the run: {alloc}")
    log("paired launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items()))
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == len(reqs), "not every request was served")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), "generated tokens out of range")
    require(per_step == {"gemv_paired_stacked": 144, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"paired path did not run through the kernels: {per_step}")
    designs = dict(ops.GEMV_VARIANT_LAUNCHES)
    require(designs == {"split": launches["gemv_paired_stacked"],
                        "staged": 0, "direct": 0},
            f"the paired path's fused GEMVs ran the designs {designs}")
    head_d = dict(ops.SHARED_GEMV_VARIANT_LAUNCHES)
    require(head_d == {"split": launches["shared_gemv"], "direct": 0},
            f"the paired path's head ran the designs {head_d}")
    dw_d = dict(ops.DWCONV_VARIANT_LAUNCHES)
    require(dw_d == {"tiled": launches["dwconv1d"], "direct": 0},
            f"the paired path's dwconv ran the designs {dw_d}")
    require(stats["table_bytes"] == tbytes, "engine and bundle table bytes "
            "differ")
    out.update(convert=conv, table_bytes=tbytes, head_pool_bytes=head_bytes,
               stack_shapes=shapes, peak_bytes=peak, steps=steps,
               allocator=alloc,
               median_step_s=med, step_seconds=eng.step_seconds,
               launches=launches, launches_per_step=per_step,
               saturation=stats.get("saturation"),
               outputs=[r.out for r in reqs], gemv_designs=designs,
               head_designs=head_d, dwconv_designs=dw_d, monitor=monitor)
    report["serve_paired"] = out
    crc_real_tables(torch, report, dec.pcilt, 5, paired=True)
    oracle_check(torch, ops, eng, report, "paired_oracle")

    # the step at B = 4: dense, unpaired (kernel 1) and paired (kernel 8)
    unpaired = convert_mamba_decode(model, params, calib, head="shared",
                                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                       device="cuda") * 0.1
                        for k, t in eng.cache["layers"].items()}}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    variants = {"dense": None, "unpaired": unpaired.pcilt,
                "paired": dec.pcilt}
    want = {"dense": {}, "unpaired": {"gemv_stacked": 144, "dwconv1d": 24,
                                      "shared_gemv": 1},
            "paired": {"gemv_paired_stacked": 144, "dwconv1d": 24,
                       "shared_gemv": 1}}
    out["step_compare"] = step_compare(torch, ops, model, params, cache, tok,
                                       variants, want)
    unpaired_bytes = unpaired.table_bytes()
    out["unpaired_table_bytes"] = unpaired_bytes
    del unpaired, variants, eng, dec
    return launches


# ----------------------------------------------------------------------------
# phase 8: exact-grid paired parity
# ----------------------------------------------------------------------------


def paired_parity(torch, ops, report):
    """``decode_e2e_pr8``'s probe (``benchmarks/run.py``): integer weights,
    scale 0.5, 2-bit symmetric codes; ``pcilt_linear(path="fused")`` on
    ``[G, V, O]`` (kernel 9) and ``pcilt_linear(paired=True,
    path="fused")`` on ``[G2, V2, O]`` (kernel 10) must be bit-equal, at
    the probe's ``[4, 64] -> 128`` and at wz's ``[4, 768] -> 1536``.
    Returns the launches."""
    from repro_torch.core.lut_layers import pcilt_linear
    from repro_torch.core.pcilt import build_grouped_tables, build_paired_tables
    from repro_torch.core.quantization import QuantSpec

    spec = QuantSpec(2, True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for n, O in [(64, 128), (768, 1536)]:
        kw = torch.randint(-2, 3, (n, O), generator=gen,
                           device="cuda").float()
        xs = torch.randint(-2, 2, (B, n), generator=gen,
                           device="cuda").float()
        cases.append((n, O, xs, build_grouped_tables(kw, spec, 0.5, 2),
                      build_paired_tables(kw, spec, 0.5, 2)))
    ops.reset_launches()
    outs = [(pcilt_linear(xs, tu, spec, 0.5, 2, path="fused"),
             pcilt_linear(xs, tp, spec, 0.5, 2, path="fused", paired=True))
            for _, _, xs, tu, tp in cases]
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    res = []
    for (n, O, xs, tu, tp), (ou, op) in zip(cases, outs):
        diff = float((ou - op).abs().max())
        plain = ops.fused_gemv_plain(xs, tu, spec, 0.5, 2)
        res.append({"shape": f"[{B}, {n}] -> {O}", "max_abs_diff": diff,
                    "equal_plain": bool(torch.equal(ou, plain))})
        log(f"paired parity [{B}, {n}] -> {O}: max |paired - unpaired| "
            f"{diff} (bit-exact contract: 0); unpaired equals its plain "
            f"version: {res[-1]['equal_plain']}")
        require(torch.equal(ou, op), f"paired parity broken at {n}->{O}")
        require(res[-1]["equal_plain"], "fused GEMV differs from its plain "
                "version on the exact grid")
    log(f"  launches: {launches}")
    require(launches == {"fused_gemv": 2, "gemv_paired": 2},
            f"parity probe did not run through kernels 9 and 10: {launches}")
    report["paired_parity"] = {"cases": res, "launches": launches}
    return launches


# ----------------------------------------------------------------------------
# phase 9: the single-layer API at full published widths
# ----------------------------------------------------------------------------


def single_layers(torch, ops, report):
    """``convert_kernel`` -> ``PCILTLinear`` on qwen3-0.6b's MLP (d 1024,
    d_ff 3072, 4-bit activations, group 2: 1.61 GB of float32 tables per
    projection) through ``path="fused"`` at B = 4 (kernel 9's split
    design), each projection against the dense product on the quantized
    grid, and the MLP over a 4 x ``PREFILL_T``-token prefill (768 rows:
    the gate and up projections on its split design, the down projection
    converted at group 1 on its staged one); ``convert_dwconv`` ->
    ``PCILTDwConv1d`` on mamba2-130m's conv frontend (C 1792, k 4, 2-bit)
    on a seeded [4, 2048, 1792] signal through ``path="kernel"``, against
    ``path="fused"`` (equal from t >= k - 1) and against its plain
    version.  Returns the launches."""
    import torch.nn.functional as F

    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import (QuantSpec, calibrate,
                                               fake_quant, quantize)
    from repro_torch.core.serving import (convert_dwconv, convert_kernel,
                                          mlp_table_bytes)
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    spec4, spec2 = QuantSpec(4, True), QuantSpec(2, True)
    out = {}
    with torch.no_grad():
        ws = {"gate": torch.randn(QWEN_D, QWEN_FF, generator=gen,
                                  device="cuda") * QWEN_D ** -0.5,
              "up": torch.randn(QWEN_D, QWEN_FF, generator=gen,
                                device="cuda") * QWEN_D ** -0.5,
              "down": torch.randn(QWEN_FF, QWEN_D, generator=gen,
                                  device="cuda") * QWEN_FF ** -0.5}
        x = torch.randn(B, QWEN_D, generator=gen, device="cuda")
        t0 = time.perf_counter()
        s_in = float(calibrate(x, spec4))
        gate = convert_kernel(ws["gate"], spec4, s_in, 2)
        up = convert_kernel(ws["up"], spec4, s_in, 2)
        torch.cuda.synchronize()
        # the down projection's input comes from the fused gate and up
        ops.reset_launches()
        g, u = gate(x, path="fused"), up(x, path="fused")
        h = F.silu(g) * u
        s_h = float(calibrate(h, spec4))
        down = convert_kernel(ws["down"], spec4, s_h, 2)
        y = down(h, path="fused")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        tb = {n_: lay.table_bytes() for n_, lay in
              (("gate", gate), ("up", up), ("down", down))}
        log(f"qwen3-0.6b MLP ({QWEN_D} -> {QWEN_FF} -> {QWEN_D}), 4-bit, "
            f"group 2: tables " + ", ".join(f"{k} {v / 1e9:.2f} GB"
                                            for k, v in tb.items())
            + f"; built and run in {build_s:.1f} s; launches {launches}")
        require(sum(tb.values()) == mlp_table_bytes(QWEN_D, QWEN_FF, 4, 2, 4),
                "MLP table bytes differ from mlp_table_bytes")
        layers = []
        for name, got, xin, s in (("gate", g, x, s_in), ("up", u, x, s_in),
                                  ("down", y, h, s_h)):
            want = fake_quant(xin, spec4, s) @ ws[name]
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max())
            layers.append({"proj": name, "max_abs_err": err, "tol": tol})
            log(f"  {name}: |fused - fake_quant(x) @ W| {err:.3e} (tol "
                f"{tol:.3e} = 1e-4 max|dense|: float32 sums of up to "
                f"{xin.shape[-1]} products in another order)")
            require(err <= tol, f"PCILTLinear {name} disagrees with the dense "
                    f"product on the quantized grid")
        # convert_kernel records each layer's CRC on the card (counted apart)
        require({k: v for k, v in launches.items() if k != "crc32"}
                == {"fused_gemv": 3},
                f"the MLP did not run through kernel 9: {launches}")
        designs = dict(ops.GEMV_VARIANT_LAUNCHES)
        require(designs == {"split": 3, "staged": 0, "direct": 0},
                f"the B = {B} MLP ran kernel 9's designs {designs}")
        # a 4 x 192-token prefill through the MLP, 768 rows: the gate and
        # up projections (group 2, V 256) on kernel 9's split, the chooser's
        # there; the down projection converted at group 1 (V 16: 201 MB of
        # tables) on its staged design (a row tile's offsets packed once,
        # the rows they name staged)
        xp = torch.randn(B, PREFILL_T, QWEN_D, generator=gen, device="cuda")
        ops.reset_launches()
        gp, upp = gate(xp, path="fused"), up(xp, path="fused")
        hp = F.silu(gp) * upp
        s_hp = float(calibrate(hp, spec4))
        down1 = convert_kernel(ws["down"], spec4, s_hp, 1)
        yp = down1(hp, path="fused")
        torch.cuda.synchronize()
        # the conversion records its CRC on the card (counted apart)
        pl = {k: v for k, v in ops.LAUNCHES.items() if v and k != "crc32"}
        pd = dict(ops.GEMV_VARIANT_LAUNCHES)
        pre = []
        for name, got, xin, s in (("gate", gp, xp, s_in),
                                  ("up", upp, xp, s_in),
                                  ("down g1", yp, hp, s_hp)):
            want = fake_quant(xin, spec4, s) @ ws[name.split()[0]]
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max())
            pre.append({"proj": name, "max_abs_err": err, "tol": tol})
            log(f"  prefill [{B}, {PREFILL_T}] {name}: |fused - "
                f"fake_quant(x) @ W| {err:.3e} (tol {tol:.3e})")
            require(err <= tol, f"the prefill's {name} disagrees with the "
                    f"dense product on the quantized grid")
        log(f"  prefill launches {pl}, designs {pd}")
        require(pl == {"fused_gemv": 3} and pd == {"split": 2, "staged": 1,
                                                   "direct": 0},
                f"the prefill did not run kernel 9's split (gate, up) and "
                f"staged (down, group 1) designs: {pl}, {pd}")
        launches["fused_gemv"] += 3
        launches["crc32"] = launches.get("crc32", 0) + ops.LAUNCHES["crc32"]
        designs["split"] += 2
        designs["staged"] += 1
        del xp, gp, upp, hp, yp, want, down1
        out["mlp"] = {"table_bytes": tb, "seconds": build_s,
                      "layers": layers, "launches": launches,
                      "designs": designs,
                      "prefill": {"shape": [B, PREFILL_T, QWEN_D],
                                  "layers": pre}}
        del gate, up, down, ws

        filt = torch.randn(CONV_K, CONV_C, generator=gen, device="cuda") * 0.5
        sig = torch.randn(B, CONV_T, CONV_C, generator=gen, device="cuda")
        s = float(calibrate(sig, spec2))
        lay = convert_dwconv(filt, spec2, s)
        ops.reset_launches()
        yk = lay(sig, path="kernel")
        torch.cuda.synchronize()
        dl = {k: v for k, v in ops.LAUNCHES.items() if v}
        dl_designs = dict(ops.DWCONV_HOST_VARIANT_LAUNCHES)
        yf = lay(sig, path="fused")
        # CAUSAL: k - 1 code-0 rows in front, as the host-packed path pads
        codes = F.pad(quantize(sig, spec2, s).int(), (0, 0, CONV_K - 1, 0))
        off = pack_offsets(torch.stack([codes[:, j:j + CONV_T]
                                        for j in range(CONV_K)], -1),
                           spec2.bits, CONV_K)[..., 0]
        plain = pcilt_dwconv1d_ref(off, lay.tables)
        torch.cuda.synchronize()
        edge = bool(torch.equal(yk[:, CONV_K - 1:], yf[:, CONV_K - 1:]))
        exact = bool(torch.equal(yk, plain))
        log(f"mamba2-130m conv frontend (C {CONV_C}, k {CONV_K}, 2-bit): "
            f"tables {lay.table_bytes() / 2**20:.2f} MiB; kernel path on "
            f"[{B}, {CONV_T}, {CONV_C}]: equals fused from t >= {CONV_K - 1}"
            f" {edge}, equals its plain version {exact}; launches {dl}")
        require(edge, "PCILTDwConv1d kernel path differs from the fused one")
        require(exact, "PCILTDwConv1d kernel path differs from its plain "
                "version")
        require(dl == {"dwconv1d_host": 1},
                f"the dwconv layer did not run through kernel 12: {dl}")
        require(dl_designs == {"staged": 1, "direct": 0},
                f"the dwconv layer ran kernel 12's designs {dl_designs}")
        out["dwconv"] = {"table_bytes": lay.table_bytes(),
                         "equal_fused_past_edge": edge,
                         "equal_plain": exact, "launches": dl,
                         "designs": dl_designs}
    block, bl = ssm_pcilt_block(torch, ops)
    out["mamba_block_pcilt"] = block
    report["single_layers"] = out
    merged = dict(launches)
    for k, v in {**dl}.items():
        merged[k] = merged.get(k, 0) + v
    for k, v in bl.items():
        merged[k] = merged.get(k, 0) + v
    return merged


def ssm_pcilt_block(torch, ops):
    """One mamba2-130m layer's ``mamba_block(pcilt=)`` at full width (d 768,
    C 1792, k 4, 4-bit symmetric conv tables: V 65536, 470 MB float32) on a
    seeded [4, 2048, 768] input in float32 compute: the whole signal goes
    through kernel 2 with CAUSAL padding (one launch, its tiled design, and
    a profile that shows it).  Kernel 2 on the block's own conv input with
    counters against its plain version, exact; the PCILT conv against the
    dense conv on the fake-quantized signal (padded with 0.0) within 1e-4
    of its largest output; the block against the same block on that dense
    conv within one bfloat16 step (2**-7) of its largest output: the SSD
    rounds its O(T) operands to bfloat16, so conv outputs ~1e-7 apart can
    round to neighbouring values there.  Returns the report and the
    block's launches (the comparison's are not counted)."""
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               scale_from_amax)
    from repro_torch.nn import ssm
    from repro_torch.nn.layers import dense
    from repro_torch.nn.module import materialize

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    k = cfg.ssm.conv_kernel
    params = materialize(ssm.mamba_spec(cfg), 21, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(B, CONV_T, cfg.d_model, generator=gen, device="cuda")
    with torch.no_grad():
        _, calib = ssm.mamba_block(params, cfg, x, return_calib=True)
        scale = float(scale_from_amax(calib["conv_in"],
                                      QuantSpec(4, symmetric=True)))
        pc = ssm.build_pcilt_conv(params, cfg, scale)
        C, V = pc["tables"].shape
        ops.reset_launches()
        y = ssm.mamba_block(params, cfg, x, pcilt=pc)
        torch.cuda.synchronize()
        bl = {k_: v for k_, v in ops.LAUNCHES.items() if v}
        designs = dict(ops.DWCONV_VARIANT_LAUNCHES)
        require(bl == {"dwconv1d": 1} and designs == {"tiled": 1,
                                                      "direct": 0},
                f"mamba_block(pcilt=) launched {bl}, designs {designs}")
        require(bool(torch.isfinite(y).all()) and y.shape == x.shape,
                "mamba_block(pcilt=) gave non-finite or misshapen output")
        prof = fullest_profile(
            torch, lambda: ssm.mamba_block(params, cfg, x, pcilt=pc))
        seen = sum(c for key, (c, _) in prof.items()
                   if DWCONV_TILED_KERNEL in key)
        dw_us = sum(t for key, (_, t) in prof.items()
                    if DWCONV_TILED_KERNEL in key)
        block_us = sum(t for _, t in prof.values())
        require(seen == 1, f"the block's profile shows {seen} launches of "
                f"{DWCONV_TILED_KERNEL}")
        # kernel 2 on the block's conv input against its plain version
        xbc = torch.cat([dense(params[n], x, cfg.dtype)
                         for n in ("wx", "wB", "wC")], -1).contiguous()
        got, gc_, gr = ops.pcilt_fused_dwconv1d(
            xbc, pc["tables"], pc["spec"], scale, k, "CAUSAL",
            with_stats=True)
        want, wc, wr = ops.dwconv1d_plain(F.pad(xbc, (0, 0, k - 1, 0)),
                                          pc["tables"], pc["spec"], scale,
                                          k, with_stats=True)
        exact = bool(torch.equal(got, want)) and int(gc_) == int(wc) \
            and float(gr) == float(wr)

        def oracle_conv(p_, cfg_, x_, conv_state=None, pcilt=None,
                        with_stats=False):
            xq = F.pad(fake_quant(x_.float(), pcilt["spec"], pcilt["scale"]),
                       (0, 0, k - 1, 0))
            w = p_["conv_w"].float()
            yo = sum(xq[:, i:i + x_.shape[1]] * w[i] for i in range(k))
            return (yo + p_["conv_b"].float()).to(x_.dtype), None

        conv, _ = ssm._conv1d(params, cfg, xbc, pcilt=pc)
        conv_o, _ = oracle_conv(params, cfg, xbc, pcilt=pc)
        conv_err = float((conv - conv_o).abs().max())
        conv_tol = 1e-4 * float(conv_o.abs().max())
        with mock.patch.object(ssm, "_conv1d", oracle_conv):
            yo = ssm.mamba_block(params, cfg, x, pcilt=pc)
        err = float((y - yo).abs().max())
        tol = 2 ** -7 * float(yo.abs().max())
    log(f"mamba2-130m mamba_block(pcilt=) at full width ([{B}, {CONV_T}, "
        f"{cfg.d_model}], conv C {C}, k {k}, 4-bit, tables "
        f"{pc['tables'].numel() * 4 / 1e6:.0f} MB): launches {bl}, "
        f"designs {designs}; profile: kernel 2 x{seen} {dw_us:.1f} us of "
        f"the block's {block_us / 1e3:.2f} ms device time; kernel 2 on the "
        f"block's conv input equals its plain version (output, count "
        f"{int(gc_)}, ratio {float(gr):.4f}) {exact}; the conv against "
        f"the dense fake-quant conv: max |d| {conv_err:.3e} (tol "
        f"{conv_tol:.3e} = 1e-4 max|oracle|); the block with either conv: "
        f"max |d| {err:.3e} (tol {tol:.3e} = 2**-7 max|oracle|)")
    require(exact, "kernel 2 on the block's conv input differs from its "
            "plain version")
    require(conv_err <= conv_tol, "the PCILT conv disagrees with the dense "
            "fake-quant conv")
    require(err <= tol, "mamba_block(pcilt=) disagrees with the block on "
            "the dense fake-quant conv")
    out = {"shape": [B, CONV_T, cfg.d_model], "conv_tables": [C, V],
           "launches": bl, "designs": designs, "profile_kernel2": seen,
           "kernel2_us": dw_us, "block_device_ms": block_us / 1e3,
           "kernel_equal_plain": exact, "count": int(gc_),
           "ratio": float(gr), "conv_max_abs_err_oracle": conv_err,
           "conv_tol": conv_tol, "block_max_abs_err_oracle": err,
           "block_tol": tol}
    del params, pc, x, y, yo, xbc, got, want, conv, conv_o
    return out, bl


# ----------------------------------------------------------------------------
# phase 10: generalized plans, custom functions and scalar shared tables
# ----------------------------------------------------------------------------


def plans_and_extensions(torch, ops, report):
    """The paper's extensions 1-3 at qwen3-0.6b's gate width (d 1024 ->
    d_ff 3072, seeded weights, a seeded [4, 1024] input, 4-bit activations,
    group 2, float32 tables, one table set at a time).  For each SegmentPlan
    of :func:`qwen_plans`: ``pcilt_linear(plan=, path="fused")`` (kernel 11)
    against its plain version, against ``path="kernel"`` (kernel 6 over
    ``plan.pack``) and against the dense oracle on the quantized grid
    (within 1e-4 of its largest output); ``perm`` bit-equal to kernel 9 on
    ``x[:, perm]``.  An exact-grid probe (integer weights, scale 0.5, [4,
    64] -> 128, a -1 slot and a reused position): kernel 11, the host path
    and the oracle bit-equal.  Extension 2: ``build_grouped_tables(fn=
    log_mul_fn)`` through kernel 9 against the gather path and the direct
    sum of ``log_mul_fn``.  Extension 3: ``build_shared_tables`` of the
    gate's 4-bit-quantized weights through ``path="shared"`` (kernel 3 at
    group 1) against ``materialize()`` + gather and the dense product.
    Returns the launches."""
    import numpy as np

    from repro_torch.core import (QuantSpec, SegmentPlan,
                                  build_grouped_tables, build_shared_tables,
                                  calibrate, dequantize, fake_quant,
                                  log_mul_fn, pcilt_linear, quantize)

    gen = torch.Generator(device="cuda").manual_seed(13)
    spec = QuantSpec(4, True)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {"plans": {}}

    head = {"split": 0, "direct": 0}
    host = {"split": 0, "staged": 0, "direct": 0}

    def counted(fn):
        """Run one call of the path, its launches counted from 0."""
        ops.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        for k, v in ops.SHARED_GEMV_VARIANT_LAUNCHES.items():
            head[k] += v
        for k, v in ops.GEMV_HOST_VARIANT_LAUNCHES.items():
            host[k] += v
        return res

    def within(what, got, want, ref):
        err = float((got - want).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        log(f"  {what}: max |d| {err:.3e} (tol {tol:.3e} = 1e-4 of the "
            f"largest output)")
        require(err <= tol, f"phase 10 {what}: {err} > {tol}")
        return err

    with torch.no_grad():
        w = torch.randn(QWEN_D, QWEN_FF, generator=gen, device="cuda") \
            * QWEN_D ** -0.5
        x = torch.randn(B, QWEN_D, generator=gen, device="cuda")
        s = float(calibrate(x, spec))
        codes = quantize(x, spec, s)
        for name, plan in qwen_plans(torch, w).items():
            t0 = time.perf_counter()
            tabs = build_grouped_tables(w, spec, s, 2, plan=plan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            nbytes = tabs.numel() * tabs.element_size()
            yf = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, plan=plan,
                                              path="fused"))
            yk = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, plan=plan,
                                              path="kernel"))
            plain = ops.gemv_plan_plain(x, tabs, plan.on("cuda"), spec, s, 2)
            oracle = torch.einsum(
                "bgj,gjo->bo", dequantize(plan.gather_codes(codes), spec, s),
                plan.gather_weights(w))
            log(f"plan {name}: G {plan.n_segments}, "
                f"{int((plan.index < 0).sum())} unused slots, positions used "
                f"{len(np.unique(plan.index[plan.index >= 0]))} of {QWEN_D}; "
                f"tables {nbytes:,} B built in {build_s:.2f} s")
            rec = {"G": plan.n_segments, "table_bytes": nbytes,
                   "build_s": build_s,
                   "vs_plain": within("kernel 11 vs its plain version", yf,
                                      plain, plain),
                   "vs_host": within("kernel 11 vs path='kernel' "
                                     "(plan.pack, kernel 6)", yf, yk,
                                     oracle),
                   "vs_oracle": within("kernel 11 vs the dense oracle", yf,
                                       oracle, oracle)}
            if name == "perm":
                gather = plan.on("cuda").long().reshape(-1)
                y9 = ops.pcilt_fused_gemv(x[:, gather].contiguous(), tabs,
                                          spec, s, 2)
                rec["equal_kernel9"] = bool(torch.equal(yf, y9))
                log(f"  kernel 11 bit-equal to kernel 9 on x[:, perm]: "
                    f"{rec['equal_kernel9']}")
                require(rec["equal_kernel9"], "kernel 11 on perm differs "
                        "from kernel 9 on the permuted x")
            out["plans"][name] = rec
            del tabs, plain, oracle

        # the exact-grid probe: a -1 slot and a reused position
        cpu = torch.Generator().manual_seed(14)
        pos = torch.randperm(64, generator=cpu)[:63].int()
        idx = torch.cat([pos, torch.tensor([-1], dtype=torch.int32),
                         pos[:2]]).numpy().reshape(-1, 2)
        plan = SegmentPlan(idx)
        kw = torch.randint(-3, 4, (64, 128), generator=gen,
                           device="cuda").float()
        xs = torch.randint(-2, 2, (B, 64), generator=gen,
                           device="cuda").float() * 0.5
        tabs = build_grouped_tables(kw, spec, 0.5, 2, plan=plan)
        pf = counted(lambda: pcilt_linear(xs, tabs, spec, 0.5, 2, plan=plan,
                                          path="fused"))
        pk = counted(lambda: pcilt_linear(xs, tabs, spec, 0.5, 2, plan=plan,
                                          path="kernel"))
        po = torch.einsum("bgj,gjo->bo", dequantize(
            plan.gather_codes(quantize(xs, spec, 0.5)), spec, 0.5),
            plan.gather_weights(kw))
        exact = bool(torch.equal(pf, pk) and torch.equal(pf, po))
        log(f"plan exact-grid probe [{B}, 64] -> 128, G {plan.n_segments} "
            f"(a -1 slot, a reused position): kernel 11, path='kernel' and "
            f"the oracle bit-equal: {exact}")
        require(exact, "the exact-grid plan probe is not bit-equal")
        out["exact_probe"] = {"equal": exact, "G": plan.n_segments}

        # extension 2: a custom convolution function
        t0 = time.perf_counter()
        tabs = build_grouped_tables(w, spec, s, 2, fn=log_mul_fn)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        yf = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, path="fused"))
        yg = pcilt_linear(x, tabs, spec, s, 2, path="gather")
        direct = log_mul_fn(w[None], dequantize(codes, spec, s)[:, :, None]) \
            .sum(1)
        log(f"log_mul_fn tables: G {tabs.shape[0]}, "
            f"{tabs.numel() * 4:,} B built in {build_s:.2f} s (chunked over "
            f"V)")
        out["log_mul"] = {
            "table_bytes": tabs.numel() * 4, "build_s": build_s,
            "vs_gather": within("kernel 9 on log_mul_fn tables vs gather",
                                yf, yg, direct),
            "vs_direct": within("kernel 9 vs sum log_mul_fn(w, val)", yf,
                                direct, direct)}
        del tabs, direct

        # extension 3: scalar shared tables of 4-bit weights
        wspec = QuantSpec(4, True)
        w4 = fake_quant(w, wspec, calibrate(w, wspec))
        t0 = time.perf_counter()
        st = build_shared_tables(w4, spec, s)
        pool = st.as_grouped_pool()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ys = counted(lambda: pcilt_linear(x, st, spec, s, 2, path="shared"))
        yd = pcilt_linear(x, st.materialize(), spec, s, 1, path="gather")
        dense = fake_quant(x, spec, s) @ w4
        pool_b = pool.pool.numel() * pool.pool.element_size()
        log(f"shared tables: {st.actual_cardinality} unique weights, a "
            f"[{st.pool.shape[0]}, {st.pool.shape[1]}] pool; 1-wide segment "
            f"pool [{', '.join(map(str, pool.pool.shape))}] = {pool_b:,} B "
            f"built in {build_s:.2f} s")
        require(st.actual_cardinality <= 16, "4-bit weights with more than "
                "16 values")
        out["shared"] = {
            "actual_cardinality": st.actual_cardinality,
            "pool_shape": list(pool.pool.shape), "pool_bytes": pool_b,
            "build_s": build_s,
            "vs_materialize": within("kernel 3 (group 1) vs materialize() + "
                                     "gather", ys, yd, dense),
            "vs_dense": within("kernel 3 vs the dense product", ys, dense,
                               dense)}
        del st, pool, yd
    seen = {k: v for k, v in launches.items() if v}
    log(f"  launches: {seen}")
    seen.pop("crc32", None)  # the layers' integrity records, counted apart
    require(seen == {"gemv_plan": 4, "gemv_host": 4, "fused_gemv": 1,
                     "shared_gemv": 1},
            f"phase 10 did not run through kernels 11, 6, 9 and 3: {seen}")
    require(head == {"split": 1, "direct": 0},
            f"phase 10's shared tables ran kernel 3's designs {head}")
    require(host == {"split": 4, "staged": 0, "direct": 0},
            f"phase 10's M = 4 host path ran kernel 6's designs {host}")
    out["launches"] = seen
    out["head_designs"] = head
    out["host_designs"] = host
    report["plans"] = out
    return seen


# ----------------------------------------------------------------------------
# phase 11: learnable tables
# ----------------------------------------------------------------------------


def learnable(torch, ops, report):
    """``launch.learnable_pcilt.run(device="cuda")``: every granularity's
    loss must fall and stay finite, each trained table served through the
    host-packed GEMV (kernel 6) must equal the gather path it trained on
    within 1e-5, and the final losses must agree with the same run on the
    CPU within 1e-4 relative (the same seeded data and base tables; the
    sums run in another order).  Returns the launches."""
    from repro_torch.launch import learnable_pcilt

    ops.reset_launches()
    res = learnable_pcilt.run(device="cuda", log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    host = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    cpu = learnable_pcilt.run(device="cpu", log=lambda m: None)
    for gran, (l0, l1) in res["losses"].items():
        require(l1 == l1 and abs(l1) != float("inf") and l1 < l0,
                f"learnable {gran}: loss {l0} -> {l1}")
        require(res["kernel_max_abs_err"][gran] <= 1e-5,
                f"learnable {gran}: the kernel path differs from gather")
        rel = abs(l1 - cpu["losses"][gran][1]) / abs(cpu["losses"][gran][1])
        log(f"  {gran}: final loss on the card {l1:.6f}, on the CPU "
            f"{cpu['losses'][gran][1]:.6f} (relative difference {rel:.2e})")
        require(rel <= 1e-4, f"learnable {gran}: the card's final loss "
                f"differs from the CPU's by {rel:.2e}")
    log(f"  launches: {launches}")
    require({k: v for k, v in launches.items() if k != "crc32"}
            == {"gemv_host": 4},
            f"the trained tables were not served through kernel 6: "
            f"{launches}")
    require(host == {"split": 4, "staged": 0, "direct": 0},
            f"the trained tables (64 rows) ran kernel 6's designs {host}")
    report["learnable"] = {**res, "cpu_losses": cpu["losses"],
                           "launches": launches, "host_designs": host}
    return launches


# ----------------------------------------------------------------------------
# phase 12: the resilience contracts at full width
# ----------------------------------------------------------------------------


def resilience(torch, ops, report):
    """The serving CLI's three contracts and a late chaos plan, each through
    ``launch.serve.run_cli`` on ``get_config("mamba2-130m")`` at full width
    (d 768, vocab 50288, 4-bit group-2 float32 tables and the shared-pool
    head) with the depth cut to ``CONTRACT_LAYERS`` layers: each contract
    builds a fault-free reference engine beside the faulted one, two
    engines of ~29 GB each (4 x 2.39 GB of layers and the 19.8 GB head),
    where two full-depth ones (~72 GiB each) would not fit one card.
    ``--chaos``, ``--chaos-drift`` and ``--chaos --traffic poisson`` (on a
    ``VirtualClock``), then ``--chaos`` again with its table faults moved
    late (``LATE_CHAOS_STEPS``): at this size the CLI plan degrades every
    request, and only the late plan leaves requests served undegraded whose
    tokens the contract holds to the fault-free run (it must leave at
    least one).  Each prints its "contract verified" line, and any
    violation fails the phase.  Returns the path's launches."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.launch import serve as srv

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              n_layers=CONTRACT_LAYERS,
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    log(f"resilience contracts: mamba2-130m at full width (d {cfg.d_model}, "
        f"vocab {cfg.vocab}), depth cut from {N_LAYERS} to {cfg.n_layers} "
        f"layers (each contract holds a faulted and a fault-free engine)")
    out = {"n_layers": cfg.n_layers, "contracts": {}}
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    plan = srv._chaos_plan

    def late_plan(eng, injector):
        return {LATE_CHAOS_STEPS.get(k, k): v
                for k, v in plan(eng, injector).items()}

    for flags, line, late in (
            (["--chaos"], "chaos contract verified", False),
            (["--chaos-drift"], "drift contract verified", False),
            (["--traffic", "poisson", "--chaos"],
             "chaos-under-traffic contract verified", False),
            (["--chaos"], "chaos contract verified", True)):
        args = srv.parse_args(["--pcilt", "--full", *flags])
        what = " ".join(flags) + (" (late plan)" if late else "")
        text = io.StringIO()
        t0 = time.perf_counter()
        srv._chaos_plan = late_plan if late else plan
        try:
            with contextlib.redirect_stdout(text):
                stats = srv.run_cli(cfg, args)
        except SystemExit as err:
            log(text.getvalue())
            raise SmokeFailure(f"contract {what}: {err}") from err
        finally:
            srv._chaos_plan = plan
        took = time.perf_counter() - t0
        printed = text.getvalue()
        for ln in printed.splitlines():
            log(f"  {ln}")
        require(line in printed, f"contract {what} printed no '{line}' line")
        # the CLI plan degrades every request at this size, so only the
        # late plan's undegraded requests hold tokens to the fault-free run
        require(not late or stats["served"] > 0,
                f"contract {what}: no request finished undegraded, so no "
                f"token was compared with the fault-free run")
        out["contracts"][what] = {
            "seconds": took, "printed": printed,
            "events": [(e["kind"], e["layer"], e["tick"])
                       for e in stats["health_events"]],
            **{k: stats[k] for k in ("served", "degraded", "failed",
                                     "rejected", "restarts", "rollbacks",
                                     "decode_ticks", "prefill_ticks")}}
        log(f"({what}: {took:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"resilience contracts: peak memory allocated "
        f"{out['peak_bytes'] / 2**30:.2f} GiB")
    report["resilience"] = out
    return {k: v for k, v in ops.LAUNCHES.items() if v}


# ----------------------------------------------------------------------------
# phase 13: the dense transformer family (qwen3-0.6b) and the LM examples
# ----------------------------------------------------------------------------


def fullest_profile(torch, fn, tries=3):
    """Device times of ``fn()`` from the profile, of ``tries``, that shows
    the most device launches (late in a run a profile can lose records
    beyond the marker's)."""
    return max((_profile(torch, fn) for _ in range(tries)),
               key=lambda p: sum(c for c, _ in p.values()))


def lead_timed(torch, fn, flush, reps=5):
    """Median device milliseconds of ``fn()`` with L2 flushed before it,
    from CUDA events around it, without the profiler (late in a run it
    loses records of composite calls).  Two flushes run ahead of each
    call, so the host has enqueued all of the call's launches before the
    device reaches them and the events hold no host gaps."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        flush()
        flush()
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)



def _logits_agree(torch, what, got, want, near_tie=False, rel=2e-2):
    """bfloat16 compute: within ``rel`` of the largest logit, argmax equal
    (with ``near_tie``, or differing only where ``want``'s choice is within
    that tolerance of ``got``'s largest logit: random weights over a
    vocabulary of 151936 give near-ties).  Returns the largest
    difference."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    tol = rel * float(want.abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    pick = got.gather(-1, want.argmax(-1, keepdim=True))[..., 0]
    tie = near_tie and bool((pick >= got.max(-1).values - tol).all())
    log(f"  {what}: max |d| {err:.4e} (tol {tol:.4e} = {rel:g} max|logit|), "
        f"argmax equal {same}" + ("" if same or not near_tie
                                  else f", a near-tie {tie}"))
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    require(err <= tol and (same or tie), f"{what}: the logits disagree")
    return err


def dense_serving(torch, ops, report):
    """qwen3-0.6b at its published width and depth (28 layers, d 1024, 16
    heads over 8 KV heads, vocab 151936; seeded float32 weights, bfloat16
    compute, a bfloat16 KV cache):

    * ``Engine(slots=4, max_len=256)`` serves 4 requests of 8 new tokens
      through its dense decode step (prompts replayed into the KV cache;
      no restart, every request served): set-up seconds, median step,
      tokens/s, peak memory, and the device time and busy share of one B =
      4 step;
    * ``make_prefill_step`` on a 192-token prompt at B = 1, timed, and on
      its first ``DENSE_REPLAY_PROMPT`` tokens against a decode replay of
      them into a 256-slot cache (the last logits within 2e-2 of the
      largest, argmax equal);
    * a 4096-token prefill (S * S >= 2048**2: the chunked attention path),
      timed, and ``_sdpa_chunked`` against ``_sdpa_dense`` on layer 0's q,
      k, v of that prompt (within 2e-2 of the largest output);
    * ``launch.serve_pcilt.run`` on the same config: layer 0's MLP (1024 ->
      3072 -> 1024) converted, each path's check, and kernel 6's time at M
      = 4 on the gate's offsets beside ``matmul``;
    * ``launch.decode_pcilt.run`` at the example's size through kernels 1
      and 2 and its oracle check, its tokens equal to the same run on the
      CPU.

    Returns the path's launches (the timing's are not counted)."""
    from repro_torch.configs import get_config
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import quantize
    from repro_torch.core.quantization import dequantize
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import decode_pcilt, serve_pcilt
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.mamba import layer_view
    from repro_torch.nn import attention as attn
    from repro_torch.nn.layers import embed, rmsnorm
    from repro_torch.nn.module import materialize

    cfg = get_config("qwen3-0.6b")
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=B, max_len=256, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(eng.params))
    log(f"qwen3-0.6b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab}; {n_params / 1e6:.1f} M float32 parameters; "
        f"engine set-up {setup_s:.1f} s")
    reqs = make_requests(cfg, 4, 8, seed=0)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    med = statistics.median(eng.step_seconds)
    gen_tokens = sum(len(r.out) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    log(f"served {stats['served']}/{len(reqs)} requests: {steps} steps "
        f"({stats['prefill_ticks']} prefill, {stats['decode_ticks']} decode) "
        f"in {stats['wall_s']:.2f} s; median step {med * 1e3:.2f} ms "
        f"({B / med:.1f} tokens/s over {B} slots; {gen_tokens} generated "
        f"tokens at {gen_tokens / stats['wall_s']:.1f} tokens/s end to end);"
        f" peak memory {peak / 2**30:.2f} GiB (weights, the KV cache and "
        f"its checkpoint ring of {eng.ckpts.maxlen})")
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == len(reqs) and stats["restarts"] == 0,
            f"the dense engine served {stats['served']} of {len(reqs)} "
            f"requests with {stats['restarts']} restarts")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), "generated tokens out of range")
    require(launches == {}, f"the dense path launched PCILT kernels "
                            f"{launches}")
    toks = torch.from_numpy(eng.tokens).cuda()

    def step():
        with torch.no_grad():
            eng.decode(eng.params, eng.cache, toks)

    step()
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    host_s = statistics.median(secs)
    prof = fullest_profile(torch, step)
    dev_s = sum(t for _, t in prof.values()) / 1e6
    dev_n = sum(c for c, _ in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"one B = {B} step (pos {eng.cache['pos']}): host {host_s * 1e3:.2f}"
        f" ms, device {dev_s * 1e3:.3f} ms in {dev_n} device launches: busy "
        f"{100 * dev_s / host_s:.1f}%; by kernel: "
        + "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms" for k, (c, t) in top))
    out["engine"] = {"setup_s": setup_s, "params": n_params,
                     "median_step_s": med, "step_seconds": eng.step_seconds,
                     "steps": steps, "wall_s": stats["wall_s"],
                     "tokens": gen_tokens, "peak_bytes": peak,
                     "outputs": [r.out for r in reqs],
                     "step_host_s": host_s, "step_device_s": dev_s,
                     "step_device_launches": dev_n,
                     "busy_share": dev_s / host_s,
                     "step_top_kernels": [(k, c, t) for k, (c, t) in top]}
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- prefill against a decode replay of the same prompt
    model_prefill = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    gen = torch.Generator().manual_seed(17)
    prompt = torch.randint(0, cfg.vocab, (1, REPLAY_PROMPT), generator=gen)
    n = DENSE_REPLAY_PROMPT
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_prefill(params, {"tokens": prompt.cuda()})
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        pre, pcache = model_prefill(params, {"tokens": prompt[:, :n].cuda()})
        cache = materialize(build_model(cfg).cache_specs(1, 256), 0, device="cuda")
        cache["pos"] = 0
        t0 = time.perf_counter()
        for t in range(n):
            logits, cache = step(params, cache, prompt[:, t:t + 1].cuda())
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    log(f"prefill of {REPLAY_PROMPT} tokens {pre_s * 1e3:.1f} ms; the first "
        f"{n} prefilled against a decode replay {replay_s * 1e3:.1f} ms ({n} "
        f"steps)")
    require(pcache["pos"] == cache["pos"] == n,
            "the prefill and the replay end at different positions")
    out["prefill_vs_replay"] = {
        "prompt": REPLAY_PROMPT, "prefill_s": pre_s, "replay_prompt": n,
        "replay_s": replay_s,
        "max_abs_err": _logits_agree(torch, "prefill against replay", pre,
                                     logits)}
    del pcache, cache

    # -- the chunked path: a 4096-token prefill, and one layer's attention
    prompt = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen)
    with torch.no_grad():
        model_prefill(params, {"tokens": prompt[:, :256].cuda()})  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        long_logits, _ = model_prefill(params, {"tokens": prompt.cuda()})
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        long_peak = torch.cuda.max_memory_allocated()
        require(bool(torch.isfinite(long_logits).all()),
                "the long prefill's logits are not finite")
        p0 = layer_view(params["blocks"], 0)["sub0"]
        x = rmsnorm(p0["ln_attn"], embed(params["embed"], prompt.cuda(),
                                         cfg.dtype), cfg.norm_eps)
        pos = torch.arange(LONG_PROMPT, device="cuda")[None]
        q, k, v = attn._project_qkv(p0["attn"], cfg, x, pos)
        kr, vr = attn._repeat_kv(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked = attn._sdpa_chunked(cfg, q, kr, vr, pos, pos, causal=True)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = attn._sdpa_dense(cfg, q, kr, vr,
                                 attn._causal_mask(pos, pos, cfg.window))
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
    err = float((chunked.float() - dense.float()).abs().max())
    tol = 2e-2 * float(dense.float().abs().max())
    log(f"prefill of {LONG_PROMPT} tokens (the chunked path): "
        f"{long_s * 1e3:.1f} ms, peak memory {long_peak / 2**30:.2f} GiB; "
        f"layer 0: chunked {chunked_s * 1e3:.2f} ms against dense "
        f"{dense_s * 1e3:.2f} ms, max |d| {err:.3e} (tol {tol:.3e} = 2e-2 "
        f"max|dense|)")
    require(err <= tol, "the chunked attention disagrees with the dense one")
    out["long_prefill"] = {"prompt": LONG_PROMPT, "seconds": long_s,
                           "peak_bytes": long_peak, "chunked_s": chunked_s,
                           "dense_s": dense_s, "max_abs_err": err,
                           "tol": tol}
    del params, q, k, v, kr, vr, chunked, dense, x
    gc.collect()
    torch.cuda.empty_cache()

    # -- serve_pcilt at full width: kernel 6 at M = 4
    log("launch.serve_pcilt.run(qwen3-0.6b):")
    ops.reset_launches()
    res = serve_pcilt.run(cfg, device="cuda", log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    pl = {k: v for k, v in ops.LAUNCHES.items() if v}
    host_d = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    require(pl.get("gemv_host") == 1 and host_d == {"split": 1, "staged": 0,
                                                    "direct": 0},
            f"serve_pcilt's kernel path ran {pl}, designs {host_d}")
    for k_, v_ in pl.items():
        launches[k_] = launches.get(k_, 0) + v_
    gate = res["gate"]
    w = res["weights"]["wg"]["kernel"]
    xq = dequantize(quantize(res["x"], gate.spec, gate.scale), gate.spec,
                    gate.scale)
    off = pack_offsets(quantize(res["x"], gate.spec, gate.scale),
                       gate.spec.bits, gate.group)
    tabs = gate.tables
    G, V, O = tabs.shape
    uniq = sum(len(torch.unique(off[:, g])) for g in range(G))
    nbytes = uniq * O * 4 + off.numel() * 4 + off.shape[0] * O * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = off.shape[0] * G * O / F32_OPS_PER_S * 1e3
    flush = L2Flush(torch)
    # by CUDA events, not the profiler: late in a run it loses records
    kt = lead_timed(torch, lambda: ops.pcilt_gemv(off, tabs), flush)
    kept = {v: lead_timed(torch, lambda v=v: ops._gemv_host(
        off, tabs, variant=v), flush) for v in ("direct", "staged")}
    pt = lead_timed(torch, lambda: ops.gemv_host_plain(off, tabs), flush)
    lt = lead_timed(torch, lambda: torch.matmul(xq, w), flush)
    row = {"shape": [off.shape[0], G, V, O], "ms": kt, "plain_ms": pt,
           "library_ms": lt, "timed_by": "CUDA events behind two L2 "
           "flushes, median of 5",
           "library_call": "torch.matmul(x_q, W)",
           "bound_ms": max(b_ms, o_ms),
           "bound_by": "bytes" if b_ms >= o_ms else "operations",
           "bytes": nbytes, "variant": "split",
           "direct_ms": kept["direct"], "staged_ms": kept["staged"]}
    log(f"  kernel 6 at M = {off.shape[0]} (the gate, G {G}, V {V}, O {O}; "
        f"the split design): {kt * 1e3:.2f} us, kept direct "
        f"{kept['direct'] * 1e3:.2f} us, kept staged "
        f"{kept['staged'] * 1e3:.2f} us, plain {pt * 1e3:.2f} us, "
        f"matmul {lt * 1e3:.2f} us (CUDA events, L2 flushed), bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    out["serve_pcilt"] = {"errors": res["errors"],
                          "table_mib": res["table_mib"], "launches": pl,
                          "host_designs": host_d, "kernel6_m4": row}
    del res, gate, w, xq, tabs, flush
    gc.collect()
    torch.cuda.empty_cache()

    # -- decode_pcilt at the example's size
    log("launch.decode_pcilt.run():")
    ops.reset_launches()
    dres = decode_pcilt.run(device="cuda", log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    dl = {k: v for k, v in ops.LAUNCHES.items() if v}
    cpu = decode_pcilt.run(device="cpu", log=lambda m: None)
    log(f"  launches {dl}; tokens on the card {dres['tokens']}, on the CPU "
        f"{cpu['tokens']}")
    require(dl.get("gemv_stacked", 0) > 0 and dl.get("dwconv1d", 0) > 0,
            f"decode_pcilt did not run through kernels 1 and 2: {dl}")
    require(dres["tokens"] == cpu["tokens"],
            "decode_pcilt's tokens on the card differ from the CPU's")
    for k_, v_ in dl.items():
        launches[k_] = launches.get(k_, 0) + v_
    out["decode_pcilt"] = {"tokens": dres["tokens"],
                           "max_abs_err": dres["max_abs_err"],
                           "launches": dl}
    report["dense"] = out
    report["dense_rows"] = {"gemv_host serve_pcilt M4": row}
    return launches


# ----------------------------------------------------------------------------


# ----------------------------------------------------------------------------
# phase 14: training
# ----------------------------------------------------------------------------


def device_params(torch, specs, seed):
    """Seeded parameters for a spec tree drawn on the card (the recipes of
    ``nn.module.materialize``, another generator): a host draw of a
    full-width config's ~1e9 parameters takes tens of seconds."""
    import math

    from repro_torch.nn.module import ParamSpec

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, device="cuda")
        if spec.init == "ones":
            return torch.ones(spec.shape, device="cuda")
        std = spec.scale
        if spec.init == "fan_in":
            fan = spec.shape[0] if len(spec.shape) == 1 else \
                math.prod(spec.shape[:-1])
            std = spec.scale / math.sqrt(max(fan, 1))
        return torch.randn(spec.shape, generator=gen, device="cuda") * std

    def walk(t):
        if isinstance(t, ParamSpec):
            return draw(t).to(t.dtype)
        return {k: walk(v) for k, v in t.items()}

    return walk(specs)


def train_args(**kw):
    """``launch.train``'s arguments, its defaults with ``kw`` set."""
    import argparse

    base = dict(arch="qwen3-0.6b", steps=5, full=True, seq=128, batch=8,
                lr=3e-3, ckpt_dir=os.path.join(ROOT, "build", "smoke_ckpt"),
                ckpt_every=1000, fail_at=[], log_every=1000, device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def step_profile(torch, fn, tries=3):
    """Device time (s) and device launches of ``fn()``, from the fullest of
    ``tries`` profiles (three more when that comes back empty), and its
    top kernels."""
    prof = fullest_profile(torch, fn, tries)
    if tries < 3 and not prof:
        prof = fullest_profile(torch, fn)
    dev_s = sum(t for _, t in prof.values()) / 1e6
    dev_n = sum(c for c, _ in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    return dev_s, dev_n, [(k[:60], c, t) for k, (c, t) in top]


def _to_card(tree):
    """A tree of host tensors copied to the card."""
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda()


def train_run(torch, cfg, args, what, box=None, mesh=None):
    """``launch.train.run`` with its output captured (from the parameters
    in ``box``, a one-element list emptied into the call, so that nothing
    here holds them; else drawn by the run; on ``mesh`` when given);
    returns the result, the output and the peak memory."""
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(buf):
        res = train.run(cfg, args, params=box.pop() if box else None,
                        mesh=mesh)
    torch.cuda.synchronize()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  [{what}] {line}")
    return res, text, torch.cuda.max_memory_allocated()


def training(torch, ops, report):
    """Training on the card (``launch.train.run`` with the supervised loop,
    AdamW with float32 moments on a cosine schedule, the seeded corpus):

    1. qwen3-0.6b ``--full`` at full width and depth (28 layers, d 1024,
       596.0 M float32 master parameters, bfloat16 compute), seq 128, batch
       8, for 6 steps: set-up seconds, the median of the last 4 steps,
       tokens/s, one step's device time and device launches, peak memory
       and each step's loss (finite, below 2 ln(vocab));
    2. (the save and restore of the whole state is phase 23's: the same
       run on a (2, 2) mesh, restored onto (1, 4));
    3. mamba2-130m at full width and depth (24 layers, d 768) for 5 steps:
       its step and losses;
    4. the restart contract at full width with the depth cut to 2 layers:
       a fault at step 4 with checkpoints every 3 steps must print
       ``restored checkpoint at step 3`` and ``restarts=1`` and end on the
       parameters and moments of an uninterrupted run, bit for bit;
    5. one train step of each smoke config (qwen3, mamba2) on the card and
       on the CPU, both in the port: the loss within 2e-2, the gradients'
       global norm within 2e-2, and each leaf within 5e-2 of its largest
       gradient (the gradients read off a probe optimizer: ``b1 = 0``, no
       clipping).

    Returns the path's launches (none: training runs no PCILT kernel)."""
    import shutil

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import count_params, materialize
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule

    out = {}
    root = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    ops.reset_launches()

    # -- 1. qwen3-0.6b at full width and depth; its seed-0 weights (the
    # trainer's own draw) kept on the host for phase 23's mesh run
    cfg = get_config("qwen3-0.6b")
    args = train_args(steps=6, ckpt_dir=os.path.join(root, "q"))
    _HANDOFF["qwen3_init"] = materialize(build_model(cfg).param_specs(), 0,
                                         device="cpu")
    res, _, peak = train_run(torch, cfg, args, "qwen3-0.6b",
                             box=[_to_card(_HANDOFF["qwen3_init"])])
    losses, secs = res["losses"], res["step_seconds"]
    med = statistics.median(secs[2:])
    tokens = args.batch * args.seq
    n_params = count_params(build_model(cfg).param_specs())
    # random weights on random tokens: the loss starts near ln(vocab)
    require(len(losses) == 6 and all(0 < l < 2 * math.log(cfg.vocab)
                                     for l in losses),
            f"qwen3-0.6b training losses {losses}")
    ocfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps),
                       weight_decay=0.01)
    step = make_train_step(cfg, None, ocfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(6).items()}
    params, opt = res["params"], res["opt"]
    dev_s, dev_n, top = step_profile(
        torch, lambda: step(params, opt, batch))
    log(f"qwen3-0.6b training: {n_params / 1e6:.1f} M parameters, set-up "
        f"{res['setup_s']:.1f} s, median step (of steps 3-6) "
        f"{med * 1e3:.1f} ms, {tokens / med:.0f} tokens/s; one step "
        f"{dev_s * 1e3:.2f} ms of device time in {dev_n} device launches "
        f"(busy {100 * dev_s / med:.1f}%); peak memory {peak / 2**30:.2f} "
        f"GiB; losses {[round(l, 4) for l in losses]}; top kernels "
        + "; ".join(f"{k[:40]} x{c} {t / 1e3:.2f} ms" for k, c, t in top))
    out["qwen3_full"] = {"layers": cfg.n_layers, "params": n_params,
                         "seq": args.seq, "batch": args.batch,
                         "setup_s": res["setup_s"], "step_seconds": secs,
                         "median_step_s": med, "tokens_per_s": tokens / med,
                         "step_device_s": dev_s,
                         "step_device_launches": dev_n,
                         "busy_share": dev_s / med, "peak_bytes": peak,
                         "losses": losses, "top_kernels": top}

    # the whole state's save and restore: phase 23 (the (2, 2) state,
    # restored elastically onto (1, 4))
    del params, opt, res, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. mamba2-130m at full width and depth
    mcfg = get_config("mamba2-130m")
    res, _, mpeak = train_run(
        torch, mcfg, train_args(arch="mamba2-130m", steps=5,
                                ckpt_dir=os.path.join(root, "m")),
        "mamba2-130m")
    mmed = statistics.median(res["step_seconds"][2:])
    require(all(map(math.isfinite, res["losses"])),
            f"mamba2-130m training losses {res['losses']}")
    log(f"mamba2-130m training ({mcfg.n_layers} layers, d {mcfg.d_model}):"
        f" median step {mmed * 1e3:.1f} ms, {tokens / mmed:.0f} tokens/s, "
        f"peak {mpeak / 2**30:.2f} GiB; losses "
        f"{[round(l, 4) for l in res['losses']]}")
    out["mamba_full"] = {"layers": mcfg.n_layers,
                         "step_seconds": res["step_seconds"],
                         "median_step_s": mmed, "peak_bytes": mpeak,
                         "losses": res["losses"]}
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. the restart contract (full width, 2 layers)
    rcfg = dataclasses.replace(cfg, n_layers=RESTART_LAYERS)
    faulted, text, _ = train_run(
        torch, rcfg, train_args(steps=5, ckpt_every=3, fail_at=[4],
                                ckpt_dir=os.path.join(root, "r1")),
        "restart")
    clean, _, _ = train_run(
        torch, rcfg, train_args(steps=5, ckpt_dir=os.path.join(root, "r2")),
        "uninterrupted")
    fa = _flat({"params": faulted["params"], "opt": faulted["opt"]})
    cl = _flat({"params": clean["params"], "opt": clean["opt"]})
    differ = [k for k in cl if not torch.equal(fa[k], cl[k])]
    restored = "restored checkpoint at step 3" in text
    one = "restarts=1" in text
    log(f"restart contract ({RESTART_LAYERS} layers at full width): "
        f"restored at step 3 {restored}, restarts=1 {one}, steps "
        f"{faulted['step']} and {clean['step']}, {len(cl)} leaves, "
        f"{len(differ)} differ from the uninterrupted run")
    require(restored and one, "the faulted run did not restore and restart")
    require(not differ, f"the restarted run's state differs: {differ[:4]}")
    out["restart"] = {"layers": RESTART_LAYERS, "restored_at": 3,
                      "restarts": faulted["stats"]["restarts"],
                      "leaves": len(cl), "differ": differ,
                      "losses_faulted": faulted["losses"],
                      "losses_clean": clean["losses"]}
    del faulted, clean, fa, cl
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. one step of each smoke config, card against CPU
    out["card_vs_cpu"] = {}
    probe = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)
    for arch in ("qwen3-0.6b", "mamba2-130m"):
        scfg = get_smoke_config(arch)
        sb = SyntheticLM(vocab=scfg.vocab, seq_len=64, global_batch=4,
                         seed=5).batch(0)
        runs = {}
        for dev in ("cuda", "cpu"):
            p = materialize(build_model(scfg).param_specs(), 0, device=dev)
            b = {k: torch.from_numpy(v).to(dev) for k, v in sb.items()}
            _, st, m = make_train_step(scfg, None, probe)(
                p, adamw_init(p, probe), b)
            runs[dev] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: v.cpu() for k, v in _flat(st["m"]).items()})
        (lg, ng, gg), (lc, nc, gc_) = runs["cuda"], runs["cpu"]
        leaf = {k: float((gg[k] - gc_[k]).abs().max()
                         / gc_[k].abs().max().clamp_min(1e-30))
                for k in gc_}
        worst = max(leaf, key=leaf.get)
        log(f"{arch} smoke train step, card against CPU: loss {lg:.5f} / "
            f"{lc:.5f}, grad norm {ng:.5f} / {nc:.5f}; worst leaf "
            f"{worst} at {leaf[worst]:.2e} of its largest gradient")
        require(abs(lg - lc) <= 2e-2 * abs(lc) and
                abs(ng - nc) <= 2e-2 * abs(nc),
                f"{arch}: the card's train step disagrees with the CPU's")
        require(leaf[worst] <= 5e-2, f"{arch}: gradient {worst} differs by "
                f"{leaf[worst]:.2e} of its largest")
        out["card_vs_cpu"][arch] = {"loss": [lg, lc], "grad_norm": [ng, nc],
                                    "leaf_rel_err": leaf}
    report["training"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"training launched PCILT kernels {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 15: the other dense configs
# ----------------------------------------------------------------------------


def dense_configs(torch, ops, report):
    """qwen1.5-4b, qwen2.5-3b and deepseek-coder-33b at their published
    widths with the depth cut (``DENSE_CUT_LAYERS``; deepseek's ~34 B
    float32 parameters at full depth do not fit one 80 GB card), seeded
    weights drawn on the card, bfloat16 compute and KV cache.  Each, as
    phase 13 for qwen3-0.6b: ``Engine(cfg, 256, 4)`` serves 4 requests of 8
    new tokens (every one served, no restart, no PCILT kernel);
    ``make_prefill_step`` on a 192-token prompt against a decode replay of
    it (2e-2 of the largest logit, argmax equal or a near-tie within that
    tolerance); ``_sdpa_chunked``
    against ``_sdpa_dense`` on layer 0's q, k, v of a 4096-token prompt
    (2e-2 of the largest output).  Returns the path's launches (none)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.nn import attention as attn
    from repro_torch.nn.layers import embed, rmsnorm
    from repro_torch.nn.module import layer_view, materialize

    out = {}
    ops.reset_launches()
    for seed, (arch, cut) in enumerate(DENSE_CUT_LAYERS.items()):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=cut)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = device_params(torch, build_model(cfg).param_specs(),
                               100 + seed)
        eng = Engine(cfg, 256, B, params=params, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n = sum(t.numel() for t in tree_leaves(params))
        reqs = make_requests(cfg, 4, 8, seed=0)
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        med = statistics.median(eng.step_seconds)
        peak = torch.cuda.max_memory_allocated()
        log(f"{arch}: {cut} of {full.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.padded_heads} (of {cfg.n_heads}) / {cfg.padded_kv_heads} "
            f"heads of {cfg.resolved_head_dim}, vocab {cfg.vocab}, qkv bias "
            f"{cfg.qkv_bias}, tied {cfg.tie_embeddings}, rope theta "
            f"{cfg.rope_theta:g}; {n / 1e6:.1f} M parameters; set-up "
            f"{setup_s:.1f} s; served {stats['served']}/4, median step "
            f"{med * 1e3:.2f} ms, peak {peak / 2**30:.2f} GiB; outputs "
            f"{[r.out for r in reqs]}")
        require(stats["served"] == 4 and stats["restarts"] == 0,
                f"{arch}: served {stats['served']} of 4 with "
                f"{stats['restarts']} restarts")
        require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab
                                            for t in r.out) for r in reqs),
                f"{arch}: generated tokens out of range")
        del eng
        gen = torch.Generator().manual_seed(17 + seed)
        prompt = torch.randint(0, cfg.vocab, (1, REPLAY_PROMPT),
                               generator=gen).cuda()
        with torch.no_grad():
            pre, _ = make_prefill_step(cfg)(params, {"tokens": prompt})
            cache = materialize(build_model(cfg).cache_specs(1, 256), 0,
                                device="cuda")
            cache["pos"] = 0
            step = make_decode_step(cfg)
            for t in range(REPLAY_PROMPT):
                logits, cache = step(params, cache, prompt[:, t:t + 1])
        rep_err = _logits_agree(torch, f"{arch} prefill against replay",
                                pre, logits, near_tie=True)
        del cache
        long = torch.randint(0, cfg.vocab, (1, LONG_PROMPT),
                             generator=gen).cuda()
        with torch.no_grad():
            p0 = layer_view(params["blocks"], 0)["sub0"]
            x = rmsnorm(p0["ln_attn"], embed(params["embed"], long,
                                             cfg.dtype), cfg.norm_eps)
            pos = torch.arange(LONG_PROMPT, device="cuda")[None]
            q, k, v = attn._project_qkv(p0["attn"], cfg, x, pos)
            kr, vr = attn._repeat_kv(q, k, v)
            chunked = attn._sdpa_chunked(cfg, q, kr, vr, pos, pos,
                                         causal=True)
            dense = attn._sdpa_dense(cfg, q, kr, vr,
                                     attn._causal_mask(pos, pos, cfg.window))
        err = float((chunked.float() - dense.float()).abs().max())
        tol = 2e-2 * float(dense.float().abs().max())
        log(f"  {arch} layer 0 at {LONG_PROMPT} tokens: chunked against "
            f"dense attention max |d| {err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"{arch}: the chunked attention disagrees")
        out[arch] = {"layers": cut, "full_layers": full.n_layers,
                     "params": n, "setup_s": setup_s, "served":
                     stats["served"], "median_step_s": med,
                     "peak_bytes": peak, "outputs": [r.out for r in reqs],
                     "replay_max_abs_err": rep_err,
                     "chunked_max_abs_err": err, "chunked_tol": tol}
        del params, q, k, v, kr, vr, chunked, dense, x, p0
        gc.collect()
        torch.cuda.empty_cache()
    report["dense_configs"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the dense configs launched PCILT kernels "
                            f"{launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 16: the MoE family (granite-moe-3b-a800m)
# ----------------------------------------------------------------------------


def _route_spy(tmoe, sink):
    """Wrap ``nn.moe._route`` so that each call appends ``(t, experts)`` to
    ``sink``; returns the original (restore it after)."""
    orig = tmoe._route

    def spy(params, cfg, x, cd):
        probs, experts, aux = orig(params, cfg, x, cd)
        sink.append((x.shape[0], experts))
        return probs, experts, aux

    tmoe._route = spy
    return orig


def _layers_cut(torch, params, n):
    """The first ``n`` layers of a stacked parameter tree, as clones (the
    full stacks can then be freed); the other leaves as they are."""
    out = dict(params)
    out["blocks"] = {}

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n].clone()

    out["blocks"] = cut(params["blocks"])
    return out


def _card_vs_cpu_train_step(torch, arch, out):
    """One smoke-config train step on the card and on the CPU (the port on
    both; whisper's batch with its frames, llava's with its image
    embeddings and the text after them): the loss and the gradients'
    global norm within 2e-2."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize
    from repro_torch.optim import AdamWConfig, adamw_init

    probe = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)
    scfg = get_smoke_config(arch)
    # the modality stubs and the image config's text slice, as the
    # trainer builds its batches
    sb = SyntheticLM(vocab=scfg.vocab, seq_len=64, global_batch=4, seed=5,
                     memory_len=scfg.encoder_len if scfg.encoder_layers
                     else 0, img_tokens=scfg.n_img_tokens,
                     d_model=scfg.d_model).batch(0)
    if scfg.n_img_tokens:
        for k in ("tokens", "labels", "loss_mask"):
            sb[k] = sb[k][:, :64 - scfg.n_img_tokens]
    runs = {}
    for dev in ("cuda", "cpu"):
        p = materialize(build_model(scfg).param_specs(), 0, device=dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in sb.items()}
        _, _, m = make_train_step(scfg, None, probe)(p, adamw_init(p, probe),
                                                     b)
        runs[dev] = {k: float(v) for k, v in m.items()}
    g, c = runs["cuda"], runs["cpu"]
    log(f"{arch} smoke train step, card against CPU: loss {g['loss']:.5f} / "
        f"{c['loss']:.5f}, grad norm {g['grad_norm']:.5f} / "
        f"{c['grad_norm']:.5f}"
        + (f", load_balance {g['load_balance']:.5f} / "
           f"{c['load_balance']:.5f}, router_z {g['router_z']:.5f} / "
           f"{c['router_z']:.5f}" if "load_balance" in g else ""))
    require(abs(g["loss"] - c["loss"]) <= 2e-2 * abs(c["loss"]) and
            abs(g["grad_norm"] - c["grad_norm"]) <= 2e-2 * abs(c["grad_norm"]),
            f"{arch}: the card's smoke train step disagrees with the CPU's")
    out["card_vs_cpu"] = {"card": g, "cpu": c}


def _train_cut(torch, cfg, holder, depths, what, out, steps=4, seq=128,
               batch=8):
    """``launch.train.run`` at the deepest of ``depths`` that fits the card,
    from the drawn parameters in ``holder["params"]`` (cut to that depth;
    redrawn on the card if a deeper try ran out of memory and consumed
    them), on ``batch`` sequences of ``seq`` tokens (an image config's
    image tokens among them).  Requires every loss finite; records the
    step, tokens/s, peak memory and the depths that ran out of memory."""
    from repro_torch.models import build_model

    oom_depths = []
    for depth in depths:
        ccfg = dataclasses.replace(cfg, n_layers=depth)
        params = holder.pop("params", None)
        if params is None:
            params = device_params(torch, build_model(ccfg).param_specs(),
                                   400 + depth)
        elif depth < cfg.n_layers:
            params = _layers_cut(torch, params, depth)
            gc.collect()
            torch.cuda.empty_cache()
        args = train_args(arch=cfg.name, steps=steps, seq=seq, batch=batch,
                          ckpt_dir=os.path.join(ROOT, "build",
                                                f"smoke_ckpt_{cfg.name}"))
        log(f"{what}: {depth} layers from "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        box = [params]  # the run frees the drawn weights after its step 0
        del params
        try:
            res, text, peak = train_run(torch, ccfg, args, what, box=box)
        except (torch.cuda.OutOfMemoryError, RuntimeError) as err:
            oom = "out of memory" in repr(err) or "out of memory" in repr(
                err.__cause__)
            box.clear()
            del err
            gc.collect()
            torch.cuda.empty_cache()
            if not oom:
                raise
            log(f"{what}: {depth} layers do not fit the card; cutting")
            oom_depths.append(depth)
            continue
        losses = res["losses"]
        med = statistics.median(res["step_seconds"][1:])
        toks = args.seq * args.batch
        log(f"{what}: {depth} of {cfg.n_layers} layers; losses "
            f"{[round(l, 4) for l in losses]}; median step {med * 1e3:.1f} "
            f"ms ({toks / med:.0f} tokens/s); peak {peak / 2**30:.2f} GiB")
        require(len(losses) == steps and all(math.isfinite(l)
                                             for l in losses),
                f"{what}: non-finite or missing losses {losses}")
        aux = [l for l in text.splitlines() if "load_balance" in l]
        out["train"] = {"layers": depth, "full_layers": cfg.n_layers,
                        "oom_layers": oom_depths, "seq": seq, "batch": batch,
                        "losses": losses, "median_step_s": med,
                        "step_seconds": res["step_seconds"],
                        "tokens_per_s": toks / med, "peak_bytes": peak,
                        "setup_s": res["setup_s"], "aux_lines": aux}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        return
    raise SmokeFailure(f"{what}: no depth of {depths} fits the card")


def _serve_engine(torch, cfg, params, what, out):
    """``Engine(cfg, 256, 4)`` on ``params`` serves 4 requests of 8 new
    tokens; records set-up, median step, tokens/s, peak memory and one B =
    4 step's host and device time and launches."""
    from repro_torch.launch.serve import Engine, make_requests

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, 256, B, params=params, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg, 4, 8, seed=0)
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    med = statistics.median(eng.step_seconds)
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    peak = torch.cuda.max_memory_allocated()
    toks = torch.from_numpy(eng.tokens).cuda()

    def step():
        with torch.no_grad():
            eng.decode(eng.params, eng.cache, toks)

    step()
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    host_s = statistics.median(secs)
    dev_s, dev_n, top = step_profile(torch, step)
    log(f"{what}: engine set-up {setup_s:.2f} s; served {stats['served']}/4 "
        f"in {steps} steps, median step {med * 1e3:.2f} ms ({B / med:.1f} "
        f"tokens/s over {B} slots); one B = {B} step host "
        f"{host_s * 1e3:.2f} ms, device {dev_s * 1e3:.3f} ms in {dev_n} "
        f"launches ({100 * dev_s / host_s:.1f}% busy); peak "
        f"{peak / 2**30:.2f} GiB; top "
        + "; ".join(f"{k[:40]} x{c} {t / 1e3:.3f} ms" for k, c, t in top))
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == 4 and stats["restarts"] == 0,
            f"{what}: served {stats['served']} of 4 with {stats['restarts']} "
            f"restarts")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), f"{what}: generated tokens out of range")
    out["engine"] = {"setup_s": setup_s, "median_step_s": med,
                     "step_seconds": eng.step_seconds, "steps": steps,
                     "tokens_per_s": B / med, "peak_bytes": peak,
                     "step_host_s": host_s, "step_device_s": dev_s,
                     "step_device_launches": dev_n, "top": top,
                     "outputs": [r.out for r in reqs]}
    del eng


def moe_family(torch, ops, report):
    """granite-moe-3b-a800m at its published width and depth (32 layers, d
    1536, 24 heads padded to 32 over 8 KV heads, 40 experts padded to 48,
    top-8, vocab 49155; seeded float32 weights drawn on the card once,
    bfloat16 compute and KV cache):

    * ``Engine(cfg, 256, 4)`` serves 4 requests of 8 new tokens (every one
      served, no restart, finite); its step's time, device time and
      launches, peak memory;
    * a 192-token prefill at B = 1, its routing entries dropped over each
      layer's capacity printed (a prefill is not held to its decode replay:
      the capacity drop makes them differ by design), the logits finite;
    * the full width cut to 2 layers on the card against the same weights
      on the CPU: the 192-token prefill and 4 greedy decode steps, the
      logits within 2e-2 of the largest (bfloat16);
    * ``launch.train.run`` from the same weights at the deepest of
      ``GRANITE_TRAIN_DEPTHS`` that fits (the unfused AdamW holds the
      parameters, gradients, both moments and the new copies of each:
      ~7 x 16.1 GB at full depth), every loss finite, the aux losses
      printed;
    * one smoke train step on the card against the CPU (2e-2).

    Returns the path's launches (none: the reference runs the MoE outside
    any Pallas kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch.steps import (active_matmul_params,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.nn import moe as tmoe

    cfg = get_config("granite-moe-3b-a800m")
    out = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    params = device_params(torch, build_model(cfg).param_specs(), 300)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"granite-moe-3b-a800m: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.padded_heads} (of {cfg.n_heads}) / {cfg.n_kv_heads} heads, "
        f"{cfg.moe.padded_experts} (of {cfg.moe.n_experts}) experts top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab}; {n / 1e9:.3f} B float32 "
        f"parameters ({4 * n / 1e9:.1f} GB, drawn on the card in "
        f"{draw_s:.1f} s), {active_matmul_params(cfg) / 1e6:.1f} M active")
    out["params"], out["draw_s"] = n, draw_s
    _serve_engine(torch, cfg, params, "granite engine", out)
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(23)
    prompt = torch.randint(0, cfg.vocab, (1, REPLAY_PROMPT), generator=gen)
    sink = []
    orig = _route_spy(tmoe, sink)
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre, _ = make_prefill_step(cfg)(params, {"tokens": prompt.cuda()})
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
    finally:
        tmoe._route = orig
    dropped = [tmoe.dropped_entries(cfg, e, t) for t, e in sink]
    cap = tmoe.moe_capacity(cfg, REPLAY_PROMPT)
    log(f"granite prefill of {REPLAY_PROMPT} tokens: {pre_s * 1e3:.1f} ms; "
        f"capacity {cap} entries an expert; entries dropped by layer "
        f"{dropped} (of {REPLAY_PROMPT * cfg.moe.top_k} a layer)")
    require(bool(torch.isfinite(pre.float()).all()),
            "granite prefill: non-finite logits")
    out["prefill"] = {"tokens": REPLAY_PROMPT, "seconds": pre_s,
                      "capacity": cap, "dropped_by_layer": dropped}

    # the full width, 2 layers, on the card against the CPU
    cut = dataclasses.replace(cfg, n_layers=GRANITE_CUT_LAYERS)
    cp = _layers_cut(torch, params, GRANITE_CUT_LAYERS)
    cpu_p = tree_map(lambda a: a.cpu(), cp)
    errs = []
    runs = {}
    for dev, p in (("cuda", cp), ("cpu", cpu_p)):
        sink = []
        orig = _route_spy(tmoe, sink)
        try:
            with torch.no_grad():
                logits, cache = make_prefill_step(cut)(
                    p, {"tokens": prompt.to(dev)})
                seq = [logits.float().cpu()]
                step = make_decode_step(cut)
                for i in range(4):
                    tok = runs["cuda"]["tokens"][i] if dev == "cpu" else \
                        seq[-1].argmax(-1)[:, None]
                    logits, cache = step(p, cache, tok.to(dev))
                    seq.append(logits.float().cpu())
        finally:
            tmoe._route = orig
        runs[dev] = {"logits": seq,
                     "tokens": [s.argmax(-1)[:, None] for s in seq],
                     "experts": [e.cpu() for _, e in sink]}
    for i, (g, c) in enumerate(zip(runs["cuda"]["logits"],
                                   runs["cpu"]["logits"])):
        g, c = g[:, :cfg.vocab], c[:, :cfg.vocab]  # not the -1e30 padding
        err = float((g - c).abs().max())
        tol = 2e-2 * float(c.abs().max())
        errs.append((err, tol))
        require(bool(torch.isfinite(g).all()) and err <= tol,
                f"granite 2-layer {'prefill' if i == 0 else f'step {i}'}: "
                f"card against CPU max |d| {err:.3e} > {tol:.3e}")
    routed = sum(int((a != b).any(-1).sum()) for a, b in
                 zip(runs["cuda"]["experts"], runs["cpu"]["experts"]))
    log(f"granite at full width, {GRANITE_CUT_LAYERS} layers, card against "
        f"CPU: prefill and 4 steps max |d| / tol "
        + ", ".join(f"{e:.3e}/{t:.3e}" for e, t in errs)
        + f"; tokens whose routing differs: {routed}")
    out["card_vs_cpu_cut"] = {"layers": GRANITE_CUT_LAYERS, "errs": errs,
                              "routing_differs": routed}
    del cp, cpu_p, runs, cache, logits
    gc.collect()
    torch.cuda.empty_cache()

    holder = {"params": params}
    del params
    _train_cut(torch, cfg, holder, GRANITE_TRAIN_DEPTHS, "granite train",
               out)
    _card_vs_cpu_train_step(torch, "granite-moe-3b-a800m", out)
    report["moe"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the MoE path launched PCILT kernels {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 17: the hybrid family (zamba2-7b)
# ----------------------------------------------------------------------------


def hybrid_family(torch, ops, report):
    """zamba2-7b at its published width and depth (81 Mamba2 blocks at d
    3584, 14 shared-attention applications over 2 parameter sets on 7168
    wide, vocab 32000; seeded float32 weights drawn on the card once,
    bfloat16 compute): ``prefill`` of 4 x ``ZAMBA_REPLAY_PROMPT`` tokens
    against a decode replay of the same prompts from an empty cache (the
    last logits within ``ZAMBA_REPLAY_TOL`` of the largest, argmax equal
    or a near-tie); a 4 x 192 prefill and 8 ``make_decode_step`` steps
    at B = 4 (each step's time, one step's device time and launches, peak
    memory), whose prompt, tokens and logits phase 23 holds its meshes
    to; the ``Engine``'s refusal; training cut to ``ZAMBA_TRAIN_LAYERS``
    (2 segments, both shared sets) from the same weights; one smoke train
    step on the card against the CPU.  Returns the path's launches
    (none)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.serve import Engine
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = get_config("zamba2-7b")
    model = build_model(cfg)
    out = {}
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = device_params(torch, model.param_specs(), 500)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"zamba2-7b: {cfg.n_layers} Mamba2 blocks, d {cfg.d_model}, "
        f"{model.n_attn_applications()} shared-attention applications of "
        f"{cfg.n_shared_attn_blocks} sets ({cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim} on {2 * cfg.d_model}), vocab {cfg.vocab}; "
        f"{n / 1e9:.3f} B float32 parameters ({4 * n / 1e9:.1f} GB, drawn "
        f"on the card in {draw_s:.1f} s)")
    out["params"], out["draw_s"] = n, draw_s
    try:
        Engine(cfg, 256, B, params=params, device="cuda")
        raise SmokeFailure("the Engine accepted the hybrid family")
    except NotImplementedError as err:
        log(f"  Engine refuses the hybrid family: {str(err)[:80]}...")

    gen = torch.Generator().manual_seed(29)
    prefill = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    out["replay"] = {}
    prompt = torch.randint(0, cfg.vocab, (B, ZAMBA_REPLAY_PROMPT),
                           generator=gen).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre, _ = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        cache = materialize(model.cache_specs(B, 256), 0, device="cuda")
        cache["pos"] = 0
        t0 = time.perf_counter()
        for t in range(ZAMBA_REPLAY_PROMPT):
            logits, cache = step(params, cache, prompt[:, t:t + 1])
        torch.cuda.synchronize()
        rep_s = time.perf_counter() - t0
    err = _logits_agree(torch, f"zamba2 prefill of {B} x "
                        f"{ZAMBA_REPLAY_PROMPT} against its decode replay",
                        pre[:, :cfg.vocab], logits[:, :cfg.vocab],
                        near_tie=True, rel=ZAMBA_REPLAY_TOL)
    out["replay"][B] = {"prefill_s": pre_s, "replay_s": rep_s,
                        "max_abs_err": err, "prompt": ZAMBA_REPLAY_PROMPT}
    log(f"  prefill {pre_s * 1e3:.1f} ms; replay {ZAMBA_REPLAY_PROMPT} steps "
        f"{rep_s:.1f} s")
    del cache, pre, logits
    # 8 decode steps at B = 4 from a 192-token prefill's cache
    with torch.no_grad():
        prompt = torch.randint(0, cfg.vocab, (B, REPLAY_PROMPT),
                               generator=gen).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        seen = [logits[:, :cfg.vocab].float().cpu()]
        torch.cuda.reset_peak_memory_stats()
        secs, toks = [], []
        for _ in range(8):
            tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, cache, tok)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            toks.append(tok[:, 0].tolist())
            seen.append(logits[:, :cfg.vocab].float().cpu())
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        dev_s, dev_n, top = step_profile(
            torch, lambda: step(params, cache, tok))
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(cache) if torch.is_tensor(t))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(secs)
    log(f"zamba2 decode at B = {B}: steps "
        + ", ".join(f"{s * 1e3:.1f}" for s in secs)
        + f" ms (median {med * 1e3:.1f}, {B / med:.1f} tokens/s); one step "
        f"{dev_s * 1e3:.3f} ms of device time in {dev_n} launches "
        f"({100 * dev_s / med:.1f}% busy); peak {peak / 2**30:.2f} GiB; top "
        + "; ".join(f"{k[:40]} x{c} {t / 1e3:.3f} ms" for k, c, t in top))
    require(bool(torch.isfinite(logits.float()).all()),
            "zamba2 decode: non-finite logits")
    out["decode"] = {"step_seconds": secs, "median_step_s": med,
                     "step_device_s": dev_s, "step_device_launches": dev_n,
                     "peak_bytes": peak, "tokens": toks, "top": top,
                     "prefill_s": pre_s}
    # phase 23 holds its meshes to this run (kept off the JSON report)
    _HANDOFF["zamba2"] = {"prompt": prompt.cpu(), "logits": seen,
                          "tokens": toks, "prefill_s": pre_s,
                          "median_step_s": med, "step_device_s": dev_s,
                          "step_device_launches": dev_n,
                          "param_bytes": 4 * n, "cache_bytes": cache_bytes}
    del cache, logits, prompt
    gc.collect()
    torch.cuda.empty_cache()

    holder = {"params": params}
    del params
    _train_cut(torch, cfg, holder, (ZAMBA_TRAIN_LAYERS,), "zamba2 train",
               out)
    _card_vs_cpu_train_step(torch, "zamba2-7b", out)
    report["hybrid"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the hybrid path launched PCILT kernels "
                            f"{launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 18: the audio family (whisper-medium)
# ----------------------------------------------------------------------------


def _decode_steps(torch, step, params, cache, tok, vocab, what, n=8):
    """``n`` decode steps from ``cache``, the first on ``tok [B, 1]``, then
    greedy: each step's host time (synchronised), one more step's device
    time and launches from a profile, the peak memory of the steps.
    Returns ``(record, logits, cache)``."""
    torch.cuda.reset_peak_memory_stats()
    secs, toks = [], []
    with torch.no_grad():
        for i in range(n):
            if i:
                tok = logits[:, :vocab].argmax(-1)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, cache, tok)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            toks.append(tok[:, 0].tolist())
        tok = logits[:, :vocab].argmax(-1)[:, None]
        dev_s, dev_n, top = step_profile(
            torch, lambda: step(params, cache, tok))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(secs)
    b = logits.shape[0]
    log(f"{what} at B = {b}: steps "
        + ", ".join(f"{s * 1e3:.1f}" for s in secs)
        + f" ms (median {med * 1e3:.1f}, {b / med:.1f} tokens/s); one step "
        f"{dev_s * 1e3:.3f} ms of device time in {dev_n} launches "
        f"({100 * dev_s / med:.1f}% busy); peak {peak / 2**30:.2f} GiB; top "
        + "; ".join(f"{k[:40]} x{c} {t / 1e3:.3f} ms" for k, c, t in top))
    require(bool(torch.isfinite(logits.float()).all()),
            f"{what}: non-finite logits")
    return ({"step_seconds": secs, "median_step_s": med,
             "step_device_s": dev_s, "step_device_launches": dev_n,
             "peak_bytes": peak, "tokens": toks, "top": top},
            logits, cache)


def _family_params(torch, name, seed, out):
    """The full config of ``name``, its model and seeded float32
    parameters drawn on the card (count and seconds logged)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models import build_model

    cfg = get_config(name)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = device_params(torch, model.param_specs(), seed)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"{name}: {cfg.n_layers} decoder layers"
        + (f" + {cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_len} frames" if cfg.encoder_layers else "")
        + (f", {cfg.n_img_tokens} image tokens, window {cfg.window}"
           if cfg.n_img_tokens else "")
        + f", d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n / 1e9:.3f} B float32 "
        f"parameters ({4 * n / 1e9:.2f} GB, drawn on the card in "
        f"{draw_s:.1f} s)")
    out["params"], out["draw_s"] = n, draw_s
    return cfg, model, params


def audio_family(torch, ops, report):
    """whisper-medium at its published width and depth (24 encoder and 24
    decoder layers, d 1024, 16 heads, d_ff 4096, vocab 51865, LayerNorm
    and GELU, sinusoidal positions; 1500 seeded stub frames; seeded
    float32 weights drawn on the card once, bfloat16 compute):

    * ``prefill`` of 192 text tokens with the frames at B = 4 against a
      decode replay of the same tokens from a
      ``WHISPER_CACHE``-slot cache holding the prefill's ``cross_kv`` (the
      last logits within 2e-2 of the largest, argmax equal or a
      near-tie); then 8 ``make_decode_step`` steps at B = 4 from the
      replay's cache (each step's time, one step's device time and
      launches, the busy share, peak memory);
    * a ``WHISPER_LONG_PROMPT``-token prefill, whose decoder
      self-attention and cross-attention take the chunked path (counted),
      against the same prefill with ``_CHUNK_THRESHOLD`` raised so that
      both take the dense one (2e-2);
    * ``launch.train.run`` at full width and depth: 128 text tokens and
      the frames, batch 8, 4 steps, every loss finite;
    * one smoke train step on the card against the CPU (2e-2).

    Returns the path's launches (none: the reference computes the
    encoder, the cross-attention and the norms outside any Pallas
    kernel)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.nn import attention as attn

    out = {}
    ops.reset_launches()
    cfg, model, params = _family_params(torch, "whisper-medium", 600, out)
    V = cfg.vocab
    gen = torch.Generator().manual_seed(37)

    def frames(b):
        return torch.randn((b, cfg.encoder_len, cfg.d_model),
                           generator=gen).cuda()

    prefill = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    out["replay"] = {}
    for b in (B,):
        batch = {"tokens": torch.randint(0, V, (b, REPLAY_PROMPT),
                                         generator=gen).cuda(),
                 "memory": frames(b)}
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre, pcache = prefill(params, batch)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            cache = device_params(torch, model.cache_specs(b, WHISPER_CACHE),
                                  0)
            cache["pos"], cache["cross_kv"] = 0, pcache["cross_kv"]
            del pcache
            t0 = time.perf_counter()
            for t in range(REPLAY_PROMPT):
                logits, cache = step(params, cache,
                                     batch["tokens"][:, t:t + 1])
            torch.cuda.synchronize()
            rep_s = time.perf_counter() - t0
        err = _logits_agree(torch, f"whisper prefill of {b} x "
                            f"{REPLAY_PROMPT} (+ {cfg.encoder_len} frames) "
                            f"against its decode replay", pre[:, :V],
                            logits[:, :V], near_tie=True)
        log(f"  prefill {pre_s * 1e3:.1f} ms (the encoder included); replay "
            f"{REPLAY_PROMPT} steps {rep_s:.2f} s")
        out["replay"][b] = {"prefill_s": pre_s, "replay_s": rep_s,
                            "max_abs_err": err}
        if b == B:
            out["decode"], logits, cache = _decode_steps(
                torch, step, params, cache, logits[:, :V].argmax(-1)[:, None],
                V, "whisper decode")
        del cache, pre, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the long prefill: the chunked path against the dense one
    batch = {"tokens": torch.randint(0, V, (1, WHISPER_LONG_PROMPT),
                                     generator=gen).cuda(),
             "memory": frames(1)}
    chunked_calls = []
    orig, orig_t = attn._sdpa_chunked, attn._CHUNK_THRESHOLD

    def spy(*a, **k):
        chunked_calls.append(a[1].shape[1] if len(a) > 1 else None)
        return orig(*a, **k)

    runs = {}
    try:
        attn._sdpa_chunked = spy
        for path, threshold in (("chunked", orig_t), ("dense", 1 << 62)):
            attn._CHUNK_THRESHOLD = threshold
            n0 = len(chunked_calls)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = prefill(params, batch)
            torch.cuda.synchronize()
            runs[path] = {"s": time.perf_counter() - t0,
                          "chunked_calls": len(chunked_calls) - n0,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "logits": logits[:, :V].float()}
    finally:
        attn._sdpa_chunked, attn._CHUNK_THRESHOLD = orig, orig_t
    err = _logits_agree(torch, f"whisper prefill of {WHISPER_LONG_PROMPT} "
                        f"tokens, chunked against dense",
                        runs["chunked"]["logits"], runs["dense"]["logits"],
                        near_tie=True)
    log("  " + "; ".join(f"{p} {r['s'] * 1e3:.1f} ms, {r['chunked_calls']} "
                         f"chunked calls, peak {r['peak_bytes'] / 2**30:.2f} "
                         f"GiB" for p, r in runs.items()))
    require(runs["chunked"]["chunked_calls"] == 2 * cfg.n_layers
            and runs["dense"]["chunked_calls"] == 0,
            f"whisper long prefill: chunked calls "
            f"{runs['chunked']['chunked_calls']} (want {2 * cfg.n_layers}: "
            f"the self- and the cross-attention of every decoder layer) and "
            f"{runs['dense']['chunked_calls']} with the threshold raised")
    out["long_prefill"] = {"tokens": WHISPER_LONG_PROMPT, "max_abs_err": err,
                           **{p: {k: v for k, v in r.items()
                                  if k != "logits"}
                              for p, r in runs.items()}}
    del runs, logits, batch
    gc.collect()
    torch.cuda.empty_cache()

    holder = {"params": params}
    del params
    _train_cut(torch, cfg, holder, (cfg.n_layers,), "whisper train", out)
    _card_vs_cpu_train_step(torch, "whisper-medium", out)
    report["audio"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the audio path launched PCILT kernels "
                            f"{launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 19: the vlm family (llava-next-mistral-7b)
# ----------------------------------------------------------------------------


def _fed_decode(torch, cfg, params, cache, toks, dev):
    """One decode step on ``dev`` for each ``[B, 1]`` token of ``toks``
    (None: greedy from the previous step; the first must be given), from
    ``cache`` copied there.  Returns each step's logits (float32, on the
    host) and the tokens fed."""
    from repro_torch.interop import tree_map
    from repro_torch.launch.steps import make_decode_step

    step = make_decode_step(cfg)
    cache = tree_map(lambda a: a.to(dev) if torch.is_tensor(a) else a, cache)
    seq, fed = [], []
    with torch.no_grad():
        for t in toks:
            if t is None:
                t = seq[-1].argmax(-1)[:, None]
            fed.append(t.cpu())
            logits, cache = step(params, cache, t.to(dev))
            seq.append(logits[:, :cfg.vocab].float().cpu())
    return seq, fed


def vlm_family(torch, ops, report):
    """llava-next-mistral-7b at its published width and depth (32 layers,
    d 4096, 32 heads over 8 KV heads, d_ff 14336, vocab 32000, a window of
    4096; 576 seeded stub image embeddings; seeded float32 weights drawn on
    the card once, bfloat16 compute):

    * a ``prefill`` of the 576 image embeddings and 191 text tokens at B =
      1, its K/V copied into the first 767 slots of a 4096-slot window
      cache, one ``decode_step`` on text token 192, against the last
      logits of the prefill of all 192 (2e-2 of the largest, argmax equal
      or a near-tie);
    * 8 decode steps at B = 4 from a 4096-slot cache of seeded K/V whose
      ``pos`` starts at ``LLAVA_WRAP_POS``, so the rolling buffer wraps
      (each step's time, one step's device time and launches, the busy
      share, peak memory);
    * the same wrap at ``LLAVA_CUT_LAYERS`` layers, full width, on the card
      against the port on the CPU (the card's tokens fed to both; 2e-2);
    * ``launch.train.run`` at the deepest of ``LLAVA_TRAIN_DEPTHS`` that
      fits, on ``LLAVA_TRAIN_SEQ`` positions (576 image + 448 text), batch
      8, 4 steps, every loss finite; the depths that ran out of memory
      logged;
    * one smoke train step on the card against the CPU (2e-2).

    Returns the path's launches (none: the reference computes the
    projector, the fusion and the windowed attention outside any Pallas
    kernel)."""
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    out = {}
    ops.reset_launches()
    cfg, model, params = _family_params(torch, "llava-next-mistral-7b", 700,
                                        out)
    V, n_img = cfg.vocab, cfg.n_img_tokens
    gen = torch.Generator().manual_seed(41)
    img = torch.randn((1, n_img, cfg.d_model), generator=gen).cuda()
    text = torch.randint(0, V, (1, LLAVA_TEXT), generator=gen).cuda()
    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = prefill(params, {"tokens": text, "img_embeds": img})
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        _, pre = prefill(params, {"tokens": text[:, :-1], "img_embeds": img})
        n = pre["pos"]
        cache = device_params(torch, model.cache_specs(1, cfg.window), 0)
        for name in ("k", "v"):
            cache["layers"]["sub0"][name][:, :, :n] = \
                pre["layers"]["sub0"][name]
        cache["pos"] = n
        del pre
        got, cache = make_decode_step(cfg)(params, cache, text[:, -1:])
    slots = cache["layers"]["sub0"]["k"].shape[2]
    require(n == n_img + LLAVA_TEXT - 1 and slots == cfg.window
            and cache["pos"] == n + 1,
            f"llava window cache: pos {n}, {slots} slots")
    err = _logits_agree(torch, f"llava decode of text token {LLAVA_TEXT} "
                        f"after a prefill of {n_img} image + "
                        f"{LLAVA_TEXT - 1} text tokens, in a {slots}-slot "
                        f"window cache, against the prefill of all "
                        f"{LLAVA_TEXT}", got[:, :V], want[:, :V],
                        near_tie=True)
    log(f"  prefill of {n_img + LLAVA_TEXT} positions {pre_s * 1e3:.1f} ms")
    out["prefill_then_decode"] = {"positions": n + 1, "prefill_s": pre_s,
                                  "max_abs_err": err}
    del cache, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # the wrap at B = 4: a full window of seeded K/V, pos near its end
    kv_gen = torch.Generator(device="cuda").manual_seed(43)
    cache = device_params(torch, model.cache_specs(B, cfg.window), 0)
    for t in tree_leaves(cache["layers"]):
        t.normal_(generator=kv_gen)
    cache["pos"] = LLAVA_WRAP_POS
    cut_cache = tree_map(lambda a: a[:LLAVA_CUT_LAYERS].clone()
                         if torch.is_tensor(a) else a, cache)
    tok0 = torch.randint(0, V, (B, 1), generator=gen).cuda()
    out["decode"], logits, cache = _decode_steps(
        torch, make_decode_step(cfg), params, cache, tok0, V,
        f"llava decode from pos {LLAVA_WRAP_POS} of a {cfg.window}-slot "
        f"window (wraps at step {cfg.window - LLAVA_WRAP_POS + 1})")
    require(cache["pos"] == LLAVA_WRAP_POS + 8,
            f"llava decode: pos {cache['pos']}")
    out["decode"]["kv_cache_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(cache["layers"]))
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the same wrap at 2 layers, full width: card against CPU
    cut = dataclasses.replace(cfg, n_layers=LLAVA_CUT_LAYERS)
    cp = _layers_cut(torch, params, LLAVA_CUT_LAYERS)
    card, fed = _fed_decode(torch, cut, cp, cut_cache, [tok0] + [None] * 7,
                            "cuda")
    cpu_p = tree_map(lambda a: a.cpu(), cp)
    del cp
    t0 = time.perf_counter()
    host, _ = _fed_decode(torch, cut, cpu_p, cut_cache, fed, "cpu")
    cpu_s = time.perf_counter() - t0
    errs = []
    for i, (g, c) in enumerate(zip(card, host)):
        e = float((g - c).abs().max())
        tol = 2e-2 * float(c.abs().max())
        errs.append((e, tol))
        require(bool(torch.isfinite(g).all()) and e <= tol,
                f"llava {LLAVA_CUT_LAYERS}-layer wrap step {i}: card against "
                f"CPU max |d| {e:.3e} > {tol:.3e}")
    log(f"llava at full width, {LLAVA_CUT_LAYERS} layers, the wrap from pos "
        f"{LLAVA_WRAP_POS}, card against CPU ({cpu_s:.1f} s on the CPU): 8 "
        f"steps max |d| / tol "
        + ", ".join(f"{e:.3e}/{t:.3e}" for e, t in errs))
    out["card_vs_cpu_cut"] = {"layers": LLAVA_CUT_LAYERS, "errs": errs,
                              "cpu_s": cpu_s}
    del cpu_p, cut_cache, card, host
    gc.collect()
    torch.cuda.empty_cache()

    holder = {"params": params}
    del params
    _train_cut(torch, cfg, holder, LLAVA_TRAIN_DEPTHS, "llava train", out,
               seq=LLAVA_TRAIN_SEQ)
    _card_vs_cpu_train_step(torch, "llava-next-mistral-7b", out)
    report["vlm"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the vlm path launched PCILT kernels "
                            f"{launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 20: the design cache
# ----------------------------------------------------------------------------


def _mamba_bundle(torch, paired, mesh=None):
    """The full-width mamba2-130m PCILT decode (4-bit, or paired 2-bit),
    seeded as phases 5 and 7 build it (its projection stacks sharded over
    ``mesh`` when one is given)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    import numpy as np

    bits = 2 if paired else 4
    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=bits, group=2),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, device="cuda")
    rng = np.random.default_rng(2)
    calib = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    dec = convert_mamba_decode(model, params, calib, paired=paired,
                               head="shared", mesh=mesh, device="cuda")
    return cfg, params, dec


def _tune_table(atn):
    """``[(key, winner, us, {design: us}, candidates)]`` of the cache."""
    rows = []
    for key, e in sorted(atn.get_cache().entries().items()):
        rows.append((key, e["design"], e["us"], atn.TIMINGS.get(key, {}),
                     e["candidates"]))
    return rows


def _log_tunes(rows, what):
    for key, design, us, times, n in rows:
        kind = key.split("|")[0]
        dims = key.split("|")[1]
        alt = ", ".join(f"{d} {t:.2f}" for d, t in times.items())
        log(f"  [{what}] {kind} {dims}: {design}"
            + (f" {us:.2f} us" if us is not None else " (untimed)")
            + (f" ({alt})" if len(times) > 1 else "") + f", {n} candidates")


def _section6_shapes(torch, ops):
    """Calls with ``autotune=True`` at the kernels' shapes of PERF.md's
    kernel table (random operands of those shapes): the head at B = 4 and
    1 (kernel 3), qwen3-0.6b's gate at B = 4 and at a 4 x 192-token
    prefill's 768 rows and its down projection at group 1 there (9: the
    split against the staged design), the paired wz width (10), the
    ``perm`` plan (11), conv4 at 1024x768 fused, shared and host-packed (4,
    5, 7), kernel 6 at M = 4 and the [4, 2048, 1792] host dwconv (12)."""
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.kernels import autotune as atn

    g = torch.Generator(device="cuda").manual_seed(31)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    s4, s2, s8 = QuantSpec(4, True), QuantSpec(2, True), QuantSpec(8, False)
    pool = rn(384, 256, 50288)
    idx = ri(384, 384)
    for b in (B, 1):
        ops.pcilt_shared_gemv(rn(b, 768), pool, idx, s4, 0.1, 2,
                              autotune=True)
    del pool
    tabs = rn(512, 256, 3072)
    ops.pcilt_fused_gemv(rn(B, 1024), tabs, s4, 0.1, 2, autotune=True)
    ops.pcilt_fused_gemv(rn(B * PREFILL_T, 1024), tabs, s4, 0.1, 2,
                         autotune=True)
    ops.pcilt_fused_gemv(rn(B * PREFILL_T, 3072), rn(3072, 16, 1024), s4,
                         0.1, 1, autotune=True)
    plan = torch.randperm(1024, generator=torch.Generator().manual_seed(3)) \
        .to(torch.int32).reshape(512, 2).cuda()
    ops.pcilt_fused_gemv_plan(rn(B, 1024), tabs, plan, s4, 0.1, 2,
                              autotune=True)
    off = ri(256, B, 512)
    ops.pcilt_gemv(off, tabs, autotune=True)
    del tabs
    ops.pcilt_fused_gemv_paired(rn(B, 768), rn(192, 256, 1536), s2, 0.1, 2,
                                autotune=True)
    ops._dwconv1d_host(ri(256, B, 2048, 1792), rn(1792, 256), autotune=True)
    H, W = FULL_HW
    img = torch.rand((1, H, W, 200), generator=g, device="cuda")
    ctab = rn(5000, 256, 350)
    # conv4's designs take 0.4-1.0 s a call and differ ~2x: one warm-up
    # and one timed call a design (not 2 and 5) choose the same winner
    with atn.using_timer(lambda fn, reps, warmup: atn.cuda_timer(fn, 1, 1)):
        ops.pcilt_fused_conv2d(img, ctab, s8, 0.01, 1, 5, 5, autotune=True)
        ops.pcilt_shared_conv2d(img, ctab, torch.arange(
            5000, dtype=torch.int32, device="cuda"), s8, 0.01, 1, 5, 5,
            autotune=True)
        del img
        ops.pcilt_conv2d(ri(256, 1, H, W, 5000), ctab, autotune=True)
    del ctab


def autotune_phase(torch, ops, report):
    """The design cache on the main paths: ``PCILTMambaDecode.tune(batch=(1,
    4))`` on the full-width mamba2-130m 4-bit and paired decodes (kernels
    1, 2, 8; every key's winner, its µs and each candidate's printed, and
    the file's size), then the kernels at ``PERF.md``'s table shapes
    (a second file); then a second process on the first file: ``tune``
    again with ``TIMING_RUNS == 0``, and the engine's tokens through the
    warm cache equal to the heuristic's.  The tuning's launches are timing
    runs, kept in the report apart from the main paths' counts; returns
    none."""
    import shutil

    from repro_torch.kernels import autotune as atn

    out = {}
    root = os.path.join(ROOT, "build", "smoke_tune")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "tiles.json")
    atn.reset_cache(path)
    atn.TIMING_RUNS = 0
    ops.reset_launches()
    for paired in (False, True):
        what = "paired" if paired else "4-bit"
        cfg, params, dec = _mamba_bundle(torch, paired)
        t0 = time.perf_counter()
        with torch.no_grad():
            dec.tune(batch=(1, B))
        torch.cuda.synchronize()
        out[f"{what}_tune_s"] = time.perf_counter() - t0
        log(f"PCILTMambaDecode.tune(batch=(1, {B})) on the {what} decode: "
            f"{out[f'{what}_tune_s']:.1f} s, {atn.TIMING_RUNS} timed runs")
        del cfg, params, dec
        gc.collect()
        torch.cuda.empty_cache()
    rows = _tune_table(atn)
    _log_tunes(rows, "decode")
    size = os.path.getsize(path)
    log(f"the cache file: {len(rows)} keys, {size} bytes")
    require(rows and all(r[1] for r in rows), "tune recorded no designs")
    out["decode"] = rows
    out["file_bytes"] = size
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    out["timing_runs"] = atn.TIMING_RUNS

    path6 = os.path.join(root, "table_shapes.json")
    atn.reset_cache(path6)
    with torch.no_grad():
        _section6_shapes(torch, ops)
    torch.cuda.synchronize()
    rows6 = _tune_table(atn)
    _log_tunes(rows6, "table shapes")
    out["table_shapes"] = rows6
    differ = [(k, d, t) for k, d, _, t, n in rows + rows6 if n > 1
              and d != next(iter(t), d)]
    log(f"winners that differ from the heuristic (its time first): "
        + ("; ".join(f"{k.split('|')[0]} {k.split('|')[1]}: {d} ("
                     + ", ".join(f"{x} {y:.2f}" for x, y in t.items())
                     + " us)" for k, d, t in differ) or "none"))
    out["differ"] = differ
    gc.collect()
    torch.cuda.empty_cache()

    # a second, fresh process on the decode file
    atn.reset_cache(os.path.join(root, "unused.json"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--autotune-warm", path], capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  [warm] {line}")
    require(proc.returncode == 0, f"the warm-cache process failed "
            f"({proc.returncode}): {proc.stderr[-2000:]}")
    warm = json.loads(proc.stdout.splitlines()[-1])
    log(f"warm process ({time.perf_counter() - t0:.1f} s): tune timed "
        f"{warm['timing_runs']} runs; engine tokens warm == heuristic "
        f"{warm['tokens_equal']}; designs warm {warm['designs_warm']}, "
        f"heuristic {warm['designs_heuristic']}")
    require(warm["timing_runs"] == 0, "the warm cache timed candidates")
    require(warm["tokens_equal"], "the warm cache's tokens differ from the "
                                  "heuristic's")
    out["warm"] = warm
    out["launches"] = launches
    report["autotune"] = out
    return {}


def autotune_warm(path):
    """The second process of phase 20: ``tune`` the 4-bit and paired decodes
    on the warm file (counting timed runs), then serve the 4-bit engine's
    requests through the warm cache and through an empty one; prints one
    JSON line."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import autotune as atn
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Engine, make_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    atn.reset_cache(path)
    atn.TIMING_RUNS = 0
    res = {}
    for paired in (True, False):
        cfg, params, dec = _mamba_bundle(torch, paired)
        with torch.no_grad():
            dec.tune(batch=(1, B))
        if paired:
            del cfg, params, dec
            gc.collect()
            torch.cuda.empty_cache()
    res["timing_runs"] = atn.TIMING_RUNS
    outs = {}
    for mode, p in (("warm", path), ("heuristic",
                                     os.path.join(os.path.dirname(path),
                                                  "empty.json"))):
        atn.reset_cache(p)
        eng = Engine(cfg, slots=B, pcilt=True, params=params,
                     pcilt_bundle=dec.pcilt, device="cuda")
        reqs = make_requests(cfg, 4, 8, seed=0)
        ops.reset_launches()
        eng.run(reqs)
        torch.cuda.synchronize()
        outs[mode] = [r.out for r in reqs]
        res[f"designs_{mode}"] = {
            "gemv": dict(ops.GEMV_VARIANT_LAUNCHES),
            "dwconv": dict(ops.DWCONV_VARIANT_LAUNCHES),
            "head": dict(ops.SHARED_GEMV_VARIANT_LAUNCHES)}
        print(f"{mode}: {outs[mode]}")
        del eng
    res["tokens_equal"] = outs["warm"] == outs["heuristic"]
    res["tokens"] = outs
    print(json.dumps(res))
    return 0


# ----------------------------------------------------------------------------
# phase 21: tensor-parallel PCILT tables
# ----------------------------------------------------------------------------


def _card_mesh(torch, D):
    """A D-shard decode mesh with every shard on this card."""
    from repro_torch.launch.mesh import make_decode_mesh

    return make_decode_mesh(D, devices=[torch.device("cuda", 0)] * D)


def _bundle_bytes(pcilt):
    """Table bytes a device of the mesh holds: each shard's projection
    blocks, and on the first device the whole conv tables and head pool
    too (they do not shard, as in the reference)."""
    from repro_torch.core.pcilt import ShardedTables

    first = pcilt["tables"].numel() * pcilt["tables"].element_size()
    head = pcilt.get("head")
    if head is not None:
        first += head["pool"].numel() * head["pool"].element_size()
    shard = sum(t.per_device_bytes() if isinstance(t, ShardedTables)
                else t.numel() * t.element_size()
                for t in pcilt["proj"]["tables"].values())
    return {"projection_stacks_per_device": shard,
            "device0_total": shard + first}


def _device_time(torch, fn, tries=3):
    """Device seconds and device launches of ``fn()``, from the fullest of
    ``tries`` profiles (late in a run a profile can come back without
    device records); fails when none saw a launch."""
    prof = fullest_profile(torch, fn, tries)
    if tries < 3 and not prof:  # an empty profile: three more
        prof = fullest_profile(torch, fn)
    n = sum(c for c, _ in prof.values())
    require(n > 0, "three profiles saw no device launch")
    return sum(t for _, t in prof.values()) / 1e6, n


def _sharded_steps(torch, ops, model, params, cache, tok, bundles, gemv,
                   out):
    """One B = 4 decode step (saturation counters on, as the engine runs
    it) of each bundle: median host time, launches, device time and device
    launches, beside the bundle's per-device table bytes; launches held to
    ``gemv`` fused GEMV launches of each bundle (kernel 1 or 8), 24 dwconv
    and 1 head.  Returns the logits of each bundle."""
    logits = {}
    with torch.no_grad():
        for name, (pc, n_gemv) in bundles.items():
            def step(pc=pc):
                return model.decode_step(params, cache, tok, pcilt=pc,
                                         with_stats=True)

            s, ln, _, _ = _step_times(torch, ops, step)
            dev_s, dev_n = _device_time(torch, step)
            logits[name] = step()[0]
            nbytes = _bundle_bytes(pc)
            want = {gemv: n_gemv, "dwconv1d": 24, "shared_gemv": 1}
            got = {k: v for k, v in ln.items() if k in want}
            out[name] = {"median_step_s": s, "launches": ln,
                         "device_s": dev_s, "device_launches": dev_n,
                         "device_share": dev_s / s, **nbytes}
            log(f"  {name:14s}: step {s * 1e3:8.2f} ms, device "
                f"{dev_s * 1e3:7.3f} ms ({100 * dev_s / s:5.1f}% busy) in "
                f"{dev_n} device launches; launches {ln}; projection stacks "
                f"{nbytes['projection_stacks_per_device'] / 1e9:.3f} GB a "
                f"device, device 0 {nbytes['device0_total'] / 1e9:.3f} GB")
            require(got == want, f"{name}: step launches {ln}, not {want}")
    return logits


def sharded_tables(torch, ops, report):
    """Tensor-parallel PCILT tables at full width, every shard on this
    card (``make_decode_mesh(D, devices=[cuda:0] * D)``; D = 2 and 4):

    (a) mamba2-130m paired (act_bits 2): the bundle converted sharded, its
        integrity record equal to the unsharded bundle's, one B = 4 step
        against the unsharded step (2e-4 of the largest logit);
    (b) mamba2-130m 4-bit sharded D = 4, built straight into its shards,
        served by ``Engine(pcilt_bundle=)`` under its monitor (4 requests of
        16 tokens, 576 / 24 / 1 launches a step), one step against the dense
        fake-quant oracle, then the ``--chaos`` plan's table fault at step
        5 flipping one shard in place: found by the monitor, the layer
        demoted, no request lost, the undegraded tokens the fault-free
        run's;
    (c) the paper CNN's conv4 at 1024x768 through kernels 4 and 5 sharded
        (``seg_offset``), against the unsharded output (1e-4 of the
        largest), and each kernel at every shard of a 64x48 crop in both
        designs against its plain version;
    (d) qwen3-0.6b's gate (1024 -> 3072) as ``PCILTLinear`` sharded on
        ``path`` fused, shared and kernel, and paired (2-bit), against the
        unsharded layer.

    Prints per-device table bytes, device time and launches beside the
    unsharded run's.  Returns the launches of the sharded paths."""
    from repro_torch.core.lut_layers import pcilt_linear
    from repro_torch.core.pcilt import ShardedTables, build_paired_tables
    from repro_torch.core.quantization import QuantSpec, calibrate
    from repro_torch.core.serving import convert_conv_kernel, convert_kernel
    from repro_torch.launch.serve import Engine, _chaos_plan, make_requests
    from repro_torch.models.cnn import dm_conv2d
    from repro_torch.nn.module import pcilt_table_sharding
    from repro_torch.runtime import FaultInjector

    out = {"card_note": "every shard on cuda:0 (one card): kernels at their "
                        "local shapes, no copy between cards"}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            if k != "crc32":  # conversion records and monitor checks
                launches[k] = launches.get(k, 0) + v

    # (a) paired, D = 2 and 4, against the unsharded bundle -----------------
    cfg, params, ref = _mamba_bundle(torch, True)
    model = ref.model
    gen = torch.Generator(device="cuda").manual_seed(9)
    specs = model.cache_specs(B, 16)["layers"]
    cache = {"layers": {k: torch.randn(s.shape, generator=gen, device="cuda")
                        * 0.1 for k, s in specs.items()}}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    integ = ref.pcilt["integrity"]
    log("(a) paired mamba2-130m, B = 4 step, counters on:")
    paired = {}
    want = _sharded_steps(torch, ops, model, params, cache, tok,
                          {"unsharded": (ref.pcilt, 144)},
                          "gemv_paired_stacked", paired)["unsharded"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for D in (2, 4):
        t0 = time.perf_counter()
        _, _, dec = _mamba_bundle(torch, True, _card_mesh(torch, D))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        require(all(isinstance(t, ShardedTables) and t.n_shards == D
                    for t in dec.pcilt["proj"]["tables"].values()),
                f"paired D = {D}: the stacks are not sharded")
        same = dec.pcilt["integrity"] == integ
        log(f"  D = {D}: converted in {build_s:.1f} s; integrity record "
            f"equal to the unsharded one's {same}")
        require(same, f"paired D = {D}: the integrity record differs")
        ops.reset_launches()
        got = _sharded_steps(torch, ops, model, params, cache, tok,
                             {f"sharded D{D}": (dec.pcilt, 144 * D)},
                             "gemv_paired_stacked", paired)[f"sharded D{D}"]
        add({k: v for k, v in ops.LAUNCHES.items() if v})
        paired[f"sharded D{D}"].update(
            build_s=build_s, max_abs_err=_logits_agree(
                torch, f"paired D = {D} against unsharded", got[:, :cfg.vocab],
                want[:, :cfg.vocab], near_tie=True, rel=2e-4))
        del dec
        gc.collect()
        torch.cuda.empty_cache()
    out["paired"] = paired
    del params, model, cache
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 4-bit, D = 4, served under the monitor ----------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, dec = _mamba_bundle(torch, False, _card_mesh(torch, 4))
    torch.cuda.synchronize()
    served = {"build_s": time.perf_counter() - t0,
              "build_peak_bytes": torch.cuda.max_memory_allocated(),
              **_bundle_bytes(dec.pcilt)}
    log(f"(b) 4-bit mamba2-130m sharded D = 4: built in "
        f"{served['build_s']:.1f} s, peak {served['build_peak_bytes'] / 2**30:.2f}"
        f" GiB (the whole stacks never beside their shards); projection "
        f"stacks {served['projection_stacks_per_device'] / 1e9:.2f} GB a "
        f"device, device 0 {served['device0_total'] / 1e9:.2f} GB")
    reqs = make_requests(cfg, 4, 16, seed=0)
    eng = Engine(cfg, slots=B, pcilt=True, params=params,
                 pcilt_bundle=dec.pcilt, device="cuda")
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    ln = {k: v for k, v in ops.LAUNCHES.items() if v}
    add(ln)
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    per_step = {k: v / steps for k, v in ln.items() if k != "crc32"}
    med = statistics.median(eng.step_seconds)
    log(f"  served {stats['served']}/{len(reqs)} requests in {steps} steps, "
        f"median step {med * 1e3:.2f} ms; launches a step {per_step}; "
        f"health events {eng.monitor.events}")
    require(stats["served"] == len(reqs) and not eng.monitor.events,
            "the sharded engine lost a request or saw a health event")
    require(per_step == {"gemv_stacked": 576, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"the sharded engine's launches a step {per_step}")
    served.update(median_step_s=med, steps=steps, launches_per_step=per_step,
                  outputs=[r.out for r in reqs])
    oracle_check(torch, ops, eng, out, key="sharded_oracle")
    unsharded = report.get("serve", {}).get("step_compare", {}).get(
        "unpaired stats")
    if unsharded is not None:  # phase 5's step, the same configuration
        log(f"  unsharded (phase 5, the same configuration): step "
            f"{unsharded['median_step_s'] * 1e3:.2f} ms, device "
            f"{unsharded['device_s'] * 1e3:.3f} ms in "
            f"{unsharded['device_launches']} device launches")
        served["unsharded_phase5"] = {k: unsharded[k] for k in (
            "median_step_s", "device_s", "device_launches")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                       device="cuda") * 0.1
                        for k, t in eng.cache["layers"].items()}}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    ops.reset_launches()
    _sharded_steps(torch, ops, eng.model, params, cache, tok,
                   {"sharded D4": (dec.pcilt, 576)}, "gemv_stacked", served)
    add({k: v for k, v in ops.LAUNCHES.items() if v})
    # the chaos plan's table fault, early enough for the round-robin
    # monitor to reach every layer before the requests finish
    faulty = Engine(cfg, slots=B, pcilt=True, params=params,
                    pcilt_bundle=dec.pcilt, device="cuda")
    injector = FaultInjector(seed=0)
    faulty.chaos = {5: _chaos_plan(faulty, injector)[15]}
    reqs2 = make_requests(cfg, 4, 16, seed=0)
    ops.reset_launches()
    stats2 = faulty.run(reqs2)
    torch.cuda.synchronize()
    add({k: v for k, v in ops.LAUNCHES.items() if v})
    breaches = [e for e in faulty.monitor.events if e["kind"] == "layer"]
    fault = injector.events[0] if injector.events else {}
    lost = [r.rid for r in reqs2 if r.outcome not in ("served", "degraded")]
    exact = [r.rid for r, q in zip(reqs2, reqs)
             if r.outcome == "served" and r.out == q.out]
    log(f"  fault: {fault}; monitor events {breaches}; outcomes "
        f"{[r.outcome for r in reqs2]}; lost {lost}")
    require("shard" in fault, "the fault did not flip a shard")
    require(breaches and "checksum breach" in breaches[0]["reason"],
            "the monitor did not find the flipped shard")
    require(not lost, f"requests lost after the fault: {lost}")
    require(all(r.out == q.out for r, q in zip(reqs2, reqs)
                if r.outcome == "served"),
            "an undegraded request's tokens differ from the fault-free run's")
    served["fault"] = {"injected": fault, "events": breaches,
                       "outcomes": [r.outcome for r in reqs2],
                       "undegraded_equal": exact,
                       "degraded": stats2["degraded"]}
    out["served"] = served
    del eng, faulty, dec, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) conv4 through kernels 4 and 5 -------------------------------------
    model, params, scales, x = paper_cnn_setup(torch)
    spec, k = model.act_spec, model.k
    layers = conv_layers(model)
    i = len(layers) - 1
    flush = L2Flush(torch)
    with torch.no_grad():
        h = x
        for j in range(i):
            h = torch.relu(dm_conv2d(h, params[f"conv{j}"], spec,
                                     scales[f"conv{j}"]))
        w, s = params[f"conv{i}"], scales[f"conv{i}"]
        conv = {"unsharded": convert_conv_kernel(w, spec, s, 1)}
        shared = {"unsharded": convert_conv_kernel(w, spec, s, 1,
                                                   weight_bits=4,
                                                   shared=True)}
        for D in (2, 4):
            m = _card_mesh(torch, D)
            conv[f"D{D}"] = convert_conv_kernel(w, spec, s, 1, mesh=m)
            shared[f"D{D}"] = convert_conv_kernel(w, spec, s, 1,
                                                  weight_bits=4, shared=True,
                                                  mesh=m)
        C, O = layers[i]
        cres = {"shape": f"B1 {FULL_HW[1]}x{FULL_HW[0]} C{C} k{k} O{O}, "
                         f"G {conv['unsharded'].n_segments}"}
        log(f"(c) conv{i} {cres['shape']}:")
        for kind, lays, path in (("fused_conv2d", conv, "fused"),
                                 ("shared_conv2d", shared, "shared")):
            ref_out = lays["unsharded"](h, path=path)
            for name, lay in lays.items():
                ops.reset_launches()
                got = lay(h, path=path)
                torch.cuda.synchronize()
                ln = {k_: v for k_, v in ops.LAUNCHES.items() if v}
                if name != "unsharded":
                    add(ln)
                err = float((got.float() - ref_out.float()).abs().max())
                tol = 1e-4 * float(ref_out.abs().max())
                # the call above warmed it
                t = time_calls(torch, [lambda lay=lay: lay(h, path=path)],
                               flush, None, reps=1, warmup=0,
                               retries=report["profile_retries"])
                # one profile of a 0.4 s call (time_calls took two)
                _, n_dev = _device_time(torch, lambda lay=lay: lay(
                    h, path=path), tries=1)
                row = {"ms": t["ms"], "warm_ms": t["warm_ms"],
                       "device_launches": n_dev,
                       "launches": ln, "max_abs_err": err, "tol": tol,
                       "table_bytes_per_device":
                           lay.per_device_table_bytes()}
                cres[f"{kind} {name}"] = row
                log(f"  {kind:13s} {name:9s}: {t['ms']:9.3f} ms (warm "
                    f"{t['warm_ms']:9.3f}) in {row['device_launches']} device"
                    f" launches; launches {ln}; tables "
                    f"{row['table_bytes_per_device'] / 1e9:.3f} GB a device;"
                    f" |d| {err:.3e} (tol {tol:.3e})")
                D = 1 if name == "unsharded" else int(name[1:])
                require(ln == {kind: D}, f"{kind} {name} launches {ln}")
                require(err <= tol, f"{kind} {name} differs from unsharded")
            del ref_out
        # each kernel at each shard of a crop, both designs, against its
        # plain version (run on the card's tensors: device-agnostic torch)
        xs = h[:, :SMALL_HW[0], :SMALL_HW[1]]
        xps = padded(xs, k, 1)
        crop = (1, *SMALL_HW, O)
        worst = {"fused_conv2d": 0.0, "shared_conv2d": 0.0}
        for D in (2, 4):
            lay, sl = conv[f"D{D}"], shared[f"D{D}"]
            Gl, n_total = lay.n_segments // D, lay.n_segments
            for d in range(D):
                kw = dict(seg_offset=d * Gl, n_total=n_total)
                pool, idx = sl.shard_pools.pools[d], sl.shard_pools.seg_idx[d]
                want_f = ops.fused_conv2d_plain(
                    xps, lay.tables.shards[d], spec, s, 1, k, k, 1,
                    **kw).reshape(crop)
                want_s = ops.shared_conv2d_plain(
                    xps, pool, idx, spec, s, 1, k, k, 1, **kw).reshape(crop)
                for v in ("staged", "direct"):
                    got_f = ops._fused_conv2d(xs, lay.tables.shards[d], spec,
                                              s, 1, k, k, variant=v, **kw)
                    got_s = ops._shared_conv2d(xs, pool, idx, spec, s, 1, k,
                                               k, variant=v, **kw)
                    for kind, g_, w_ in (("fused_conv2d", got_f, want_f),
                                         ("shared_conv2d", got_s, want_s)):
                        e = float((g_.float() - w_.float()).abs().max())
                        tol = 1e-4 * float(w_.abs().max())
                        worst[kind] = max(worst[kind], e)
                        require(e <= tol, f"{kind} shard {d} of {D} ({v}) "
                                f"differs from its plain version: {e:.3e}")
        log(f"  each shard of D = 2, 4 on the {SMALL_HW[1]}x{SMALL_HW[0]} "
            f"crop, both designs, against the plain version: max |d| "
            f"{worst}")
        cres["seg_offset_max_abs_err"] = worst
        out["conv4"] = cres
        del conv, shared, h, x, flush
        gc.collect()
        torch.cuda.empty_cache()

    # (d) qwen3-0.6b's gate ----------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(11)
    spec4, spec2 = QuantSpec(4, True), QuantSpec(2, True)
    lres = {"shape": f"B{B} {QWEN_D} -> {QWEN_FF}"}
    flush = L2Flush(torch)
    log(f"(d) qwen3-0.6b gate {lres['shape']}:")
    with torch.no_grad():
        wg = torch.randn(QWEN_D, QWEN_FF, generator=gen,
                         device="cuda") * QWEN_D ** -0.5
        x = torch.randn(B, QWEN_D, generator=gen, device="cuda")
        s4, s2 = float(calibrate(x, spec4)), float(calibrate(x, spec2))
        paired = build_paired_tables(wg, spec2, s2, 2)
        cases = []
        for D in (1, 2, 4):
            m = None if D == 1 else _card_mesh(torch, D)
            dense = convert_kernel(wg, spec4, s4, 2, mesh=m)
            sh = convert_kernel(wg, spec4, s4, 2, weight_bits=4, shared=True,
                                mesh=m)
            pt = paired if D == 1 else ShardedTables.place(
                paired, pcilt_table_sharding(m, paired.shape[0]))
            cases += [(D, "fused", lambda l=dense: l(x, path="fused"),
                       "fused_gemv", dense.per_device_table_bytes()),
                      (D, "kernel", lambda l=dense: l(x, path="kernel"),
                       "gemv_host", dense.per_device_table_bytes()),
                      (D, "shared", lambda l=sh: l(x, path="shared"),
                       "shared_gemv", sh.per_device_table_bytes()),
                      (D, "paired", lambda t=pt, m=m: pcilt_linear(
                          x, t, spec2, s2, 2, path="fused", mesh=m,
                          paired=True), "gemv_paired",
                       (pt.per_device_bytes() if D > 1 else
                        pt.numel() * pt.element_size()))]
        refs = {}
        for D, path, call, kname, nbytes in cases:
            ops.reset_launches()
            got = call()
            torch.cuda.synchronize()
            ln = {k_: v for k_, v in ops.LAUNCHES.items() if v}
            if D > 1:
                add(ln)
            if D == 1:
                refs[path] = got
            err = float((got.float() - refs[path].float()).abs().max())
            tol = 1e-4 * float(refs[path].abs().max())
            t = time_calls(torch, [call], flush, None, reps=1, warmup=1,
                           retries=report["profile_retries"])
            _, n_dev = _device_time(torch, call)
            row = {"ms": t["ms"], "warm_ms": t["warm_ms"],
                   "device_launches": n_dev,
                   "launches": ln, "max_abs_err": err, "tol": tol,
                   "table_bytes_per_device": nbytes}
            lres[f"{path} D{D}"] = row
            log(f"  {path:6s} D = {D}: {t['ms'] * 1e3:9.2f} us (warm "
                f"{t['warm_ms'] * 1e3:9.2f}) in {row['device_launches']} "
                f"device launches; launches {ln}; tables "
                f"{nbytes / 1e9:.3f} GB a device; |d| {err:.3e} "
                f"(tol {tol:.3e})")
            require(ln == {kname: D}, f"gate {path} D = {D} launches {ln}")
            require(err <= tol, f"gate {path} D = {D} differs from unsharded")
        del cases, refs, paired, flush
    out["gate"] = lres
    log(f"sharded paths' launches: {launches}")
    report["sharded"] = out
    return launches


# ----------------------------------------------------------------------------
# phase 22: the dense family and the Mamba engine served on a mesh
# ----------------------------------------------------------------------------


def _card_host_mesh(torch, shape):
    """A (data, model) mesh of ``shape`` with every device this card."""
    from repro_torch.launch.mesh import make_host_mesh

    n = shape[0] * shape[1]
    return make_host_mesh(*shape, devices=[torch.device("cuda", 0)] * n)


def _mesh_timed(torch, fn, what, warm=True):
    """Host milliseconds (the mean of 2 synchronised calls after a warm
    one; ``warm=False`` when the caller's own call just warmed it), device
    milliseconds and device launches (one profile; the fullest of three
    when it comes back empty) of ``fn()``; logs and returns them."""
    if warm:
        fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    host = statistics.median(secs)
    prof = _profile(torch, fn)
    if not prof:  # late in a run a profile can come back empty
        prof = fullest_profile(torch, fn)
    dev_n = sum(c for c, _ in prof.values())
    require(dev_n > 0, f"{what}: the profiles saw no device launch")
    dev_s = sum(t for _, t in prof.values()) / 1e6
    log(f"  {what}: host {host * 1e3:.2f} ms, device {dev_s * 1e3:.3f} ms "
        f"in {dev_n} device launches ({100 * dev_s / host:.1f}% busy)")
    return {"host_ms": host * 1e3, "device_ms": dev_s * 1e3,
            "device_launches": dev_n}


def _card_draw(torch, specs, gen):
    """A spec tree's parameters drawn on the card from ``gen`` by the
    specs' init recipes (random weights, seeded)."""
    from repro_torch.nn.module import ParamSpec

    if not isinstance(specs, ParamSpec):
        return {k: _card_draw(torch, v, gen) for k, v in specs.items()}
    if specs.init in ("zeros", "ones"):
        fill = torch.zeros if specs.init == "zeros" else torch.ones
        return fill(specs.shape, device="cuda", dtype=specs.dtype)
    std = specs.scale
    if specs.init == "fan_in":
        fan_in = specs.shape[0] if len(specs.shape) == 1 else \
            math.prod(specs.shape[:-1])
        std = specs.scale / math.sqrt(max(fan_in, 1))
    return (torch.randn(specs.shape, generator=gen, device="cuda") * std) \
        .to(specs.dtype)


def _per_device_gb(tree):
    """The bytes each mesh coordinate holds of a placed tree (GB); fails
    unless every coordinate holds the same."""
    from repro_torch.nn.module import device_bytes

    per = device_bytes(tree)
    require(len(set(per.values())) == 1,
            f"the mesh's devices hold different bytes: {per}")
    return next(iter(per.values())) / 1e9


def mesh_serving(torch, ops, report):
    """The sharding context on this card (every mesh device ``cuda:0``:
    this measures what the shards cost, not a gain):

    (a) qwen3-0.6b at its published width and depth: ``Engine(cfg, 256, 4,
        mesh)`` on (1, 2), (1, 4) and (2, 2), on ``MESH_SERVED`` serving 4
        requests of 8 new tokens with the unsharded engine's tokens (the
        other meshes' steps timed below); bytes a device of the
        parameters and the cache (each device's checked by the engine
        against the partition specs) and the leaves the divisibility
        fallback replicates; one B = 4 decode step from the unsharded
        engine's final cache against the unsharded step (1e-2 of the
        largest logit);
    (b) a 192-token prefill through ``make_prefill_step(cfg, mesh)`` on
        each mesh against the unsharded step (1e-2);
    (c) kvshard: a decode at (1, 4) with ``{"cache_seq": "model"}`` (the
        cache's time axis over the model devices, merged by log-sum-exp);
    (d) mamba2-130m paired (act_bits 2): ``Engine(mesh=(1, 4), pcilt=True,
        pcilt_bundle=)`` against the unsharded paired engine (tokens; one
        step within 2e-4 of the largest logit; its kernel launches a step
        the unsharded step's);
    (e) ``pipeline_apply`` over 4 stages of 7 qwen3-0.6b blocks each, 4
        microbatches of 64 tokens, against the blocks in sequence.

    Each step prints its host ms, device ms and device launches and its
    largest |difference| from the unsharded run.  Returns the launches of
    the Mamba engine's run on the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_apply
    from repro_torch.nn.layers import embed
    from repro_torch.nn.module import (layer_view, place, shardings,
                                       spec_bytes)
    from repro_torch.runtime import pipeline_apply

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg)
    out = {"card_note": "every mesh device is cuda:0 (one card): the "
                        "shards' cost, not a gain", "meshes": {}}
    t0 = time.perf_counter()
    whole = _card_draw(torch, model.param_specs(),
                       torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    cspecs = model.cache_specs(B, 256)
    pb, cb = spec_bytes(model.param_specs()), spec_bytes(cspecs["layers"])
    log(f"qwen3-0.6b drawn in {time.perf_counter() - t0:.1f} s: parameters "
        f"{pb / 1e9:.3f} GB, KV cache at B = {B}, T = 256 {cb / 1e9:.3f} GB")
    out["whole_gb"] = {"params": pb / 1e9, "cache": cb / 1e9}

    # (a) the unsharded engine, then one step from its final cache
    reqs = make_requests(cfg, 4, 8, seed=0)
    eng = Engine(cfg, 256, B, params=whole, seed=0, device="cuda")
    stats = eng.run(reqs)
    require(stats["served"] == 4, "the unsharded engine lost a request")
    tokens = [r.out for r in reqs]
    cache0, toks = eng.cache, torch.from_numpy(eng.tokens).cuda()
    step0 = make_decode_step(cfg)
    with torch.no_grad():
        want = step0(whole, cache0, toks)[0].float()
        out["unsharded_step"] = _mesh_timed(
            torch, lambda: step0(whole, cache0, toks), "unsharded B = 4 step")
    del eng
    gc.collect()
    gen = torch.Generator().manual_seed(17)
    prompt = torch.randint(0, cfg.vocab, (1, REPLAY_PROMPT),
                           generator=gen).cuda()
    pre0 = make_prefill_step(cfg)
    with torch.no_grad():
        want_pre = pre0(whole, {"tokens": prompt})[0].float()
        out["unsharded_prefill"] = _mesh_timed(
            torch, lambda: pre0(whole, {"tokens": prompt}),
            f"unsharded {REPLAY_PROMPT}-token prefill")
    for shape in MESH_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        mesh = _card_host_mesh(torch, shape)
        t0 = time.perf_counter()
        eng = Engine(cfg, 256, B, mesh, params=whole, seed=0)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        row = {"setup_s": setup,
               "params_gb_per_device": _per_device_gb(eng.params),
               "cache_gb_per_device": _per_device_gb(eng.cache),
               "replicated_leaves": len(eng.replicated_leaves)}
        log(f"mesh {name}: placed in {setup:.1f} s; a device holds "
            f"{row['params_gb_per_device']:.3f} GB of parameters and "
            f"{row['cache_gb_per_device']:.3f} GB of cache; "
            f"{row['replicated_leaves']} leaves replicated by the fallback "
            f"{sorted(set(l.split('[')[1] for l in eng.replicated_leaves))}")
        if shape == MESH_SERVED:  # the other meshes' steps are timed below
            got_reqs = make_requests(cfg, 4, 8, seed=0)
            st = eng.run(got_reqs)
            row["engine_wall_s"] = st["wall_s"]
            row["median_engine_step_ms"] = \
                statistics.median(eng.step_seconds) * 1e3
            row["tokens_equal"] = [r.out for r in got_reqs] == tokens
            log(f"  served {st['served']}/4 in {st['wall_s']:.2f} s (median "
                f"step {row['median_engine_step_ms']:.2f} ms); tokens equal "
                f"to the unsharded engine's {row['tokens_equal']}")
            require(st["served"] == 4 and row["tokens_equal"],
                    f"mesh {name}: the engine's tokens differ")
        cm = place(cache0, shardings(cspecs, mesh))
        dec = make_decode_step(cfg, mesh)
        with torch.no_grad():
            got = dec(eng.params, cm, toks)[0]
            row["step"] = _mesh_timed(
                torch, lambda: dec(eng.params, cm, toks),
                f"{name} B = {B} step", warm=False)
            row["step"]["max_abs_diff"] = _logits_agree(
                torch, f"{name} step against the unsharded", got, want,
                near_tie=True, rel=1e-2)
            pre = make_prefill_step(cfg, mesh)
            got = pre(eng.params, {"tokens": prompt})[0]
            row["prefill"] = _mesh_timed(
                torch, lambda: pre(eng.params, {"tokens": prompt}),
                f"{name} {REPLAY_PROMPT}-token prefill", warm=False)
            row["prefill"]["max_abs_diff"] = _logits_agree(
                torch, f"{name} prefill against the unsharded", got, want_pre,
                near_tie=True, rel=1e-2)
            if shape == KVSHARD_MESH:
                ov = {"cache_seq": "model"}
                rules = make_ctx(mesh, ov).rules
                ck = place(cache0, shardings(cspecs, mesh, rules))
                kv = make_decode_step(cfg, mesh, ov)
                got = kv(eng.params, ck, toks)[0]
                row["kvshard"] = _mesh_timed(
                    torch, lambda: kv(eng.params, ck, toks),
                    f"{name} kvshard step", warm=False)
                row["kvshard"]["cache_gb_per_device"] = _per_device_gb(ck)
                row["kvshard"]["cache_spec"] = list(
                    ck["layers"]["sub0"]["k"].spec)
                row["kvshard"]["max_abs_diff"] = _logits_agree(
                    torch, f"{name} kvshard against the unsharded", got,
                    want, near_tie=True, rel=1e-2)
                del ck
        out["meshes"][name] = row
        del eng, cm
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the pipeline: 4 stages of 7 blocks, 4 microbatches
    n_per = cfg.n_layers // PIPE_STAGES
    stages = tree_map(lambda t: t.reshape(PIPE_STAGES, n_per, *t.shape[1:]),
                      whole["blocks"])
    toks_p = torch.randint(0, cfg.vocab, (PIPE_MICRO, 1, PIPE_SEQ),
                           generator=gen).cuda()
    pos = torch.arange(PIPE_SEQ, device="cuda")[None]
    with torch.no_grad():
        x = embed(whole["embed"], toks_p, cfg.dtype)

        def stage(p, a):
            for l in range(n_per):
                a = block_apply(layer_view(p, l)["sub0"], cfg, a, pos)[0]
            return a

        smesh = make_mesh((PIPE_STAGES,), ("stage",),
                          devices=[torch.device("cuda", 0)] * PIPE_STAGES)
        got = pipeline_apply(stage, stages, x, smesh)

        def sequential():
            ys = []
            for m in range(PIPE_MICRO):
                a = x[m]
                for s in range(PIPE_STAGES):
                    a = stage(layer_view(stages, s), a)
                ys.append(a)
            return torch.stack(ys)

        want_p = sequential()
        err = float((got.float() - want_p.float()).abs().max())
        pipe = {"stages": PIPE_STAGES, "blocks_per_stage": n_per,
                "microbatches": PIPE_MICRO, "max_abs_diff": err}
        pipe["pipeline"] = _mesh_timed(
            torch, lambda: pipeline_apply(stage, stages, x, smesh),
            f"pipeline_apply {PIPE_STAGES} x {n_per} blocks, {PIPE_MICRO} "
            f"microbatches of {PIPE_SEQ} tokens")
        pipe["sequential"] = _mesh_timed(torch, sequential,
                                         "the same blocks in sequence")
    log(f"  pipeline against the blocks in sequence: max |d| {err:.4e}")
    require(err <= 1e-2 * float(want_p.float().abs().max()),
            "the pipeline's outputs differ from the sequential blocks'")
    out["pipeline"] = pipe
    del whole, cache0, stages, x
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the paired Mamba engine on (1, 4) against the unsharded one
    t0 = time.perf_counter()
    mcfg, mparams, dec = _mamba_bundle(torch, True)
    torch.cuda.synchronize()
    log(f"paired mamba2-130m converted in {time.perf_counter() - t0:.1f} s")
    mesh = _card_host_mesh(torch, (1, 4))
    mreqs = make_requests(mcfg, 4, 8, seed=0)
    e0 = Engine(mcfg, 64, B, pcilt=True, params=mparams,
                pcilt_bundle=dec.pcilt, device="cuda")
    t0 = time.perf_counter()
    e0.run(mreqs)
    log(f"  the unsharded paired engine served in "
        f"{time.perf_counter() - t0:.1f} s")
    mtokens = [r.out for r in mreqs]
    c0, mt = e0.cache, torch.from_numpy(e0.tokens).cuda()
    with torch.no_grad():
        mwant = e0.pdecode.step(e0.params, c0, mt, with_stats=True)[0]
        s, ln, dev_s, dev_n = _step_times(
            torch, ops, lambda: e0.pdecode.step(e0.params, c0, mt,
                                                with_stats=True))
    mamba = {"unsharded": {"host_ms": s * 1e3, "device_ms": dev_s * 1e3,
                           "device_launches": dev_n, "launches": ln}}
    log(f"  paired mamba2-130m unsharded step: host {s * 1e3:.2f} ms, device "
        f"{dev_s * 1e3:.3f} ms in {dev_n} device launches; launches {ln}")
    del e0
    gc.collect()
    ops.reset_launches()
    e1 = Engine(mcfg, 64, B, mesh, pcilt=True, params=mparams,
                pcilt_bundle=dec.pcilt)
    got_reqs = make_requests(mcfg, 4, 8, seed=0)
    e1.run(got_reqs)
    torch.cuda.synchronize()
    # the conversion record's and the monitor's CRCs are not the path's
    launches = {k: v for k, v in ops.LAUNCHES.items()
                if v and k != "crc32"}
    same = [r.out for r in got_reqs] == mtokens
    log(f"  paired mamba2-130m on (1, 4): tokens equal to the unsharded "
        f"engine's {same}; the SSD state a device "
        f"{_per_device_gb(e1.cache) * 1e3:.3f} MB of "
        f"{spec_bytes(e1.model.cache_specs(B)['layers']) / 1e6:.3f} MB")
    require(same, "the paired Mamba engine on the mesh changed its tokens")
    cm = place(c0, shardings(e1.model.cache_specs(B), mesh))
    with torch.no_grad():
        mgot = e1.pdecode.step(e1.params, cm, mt, with_stats=True)[0]
        s, ln1, dev_s, dev_n = _step_times(
            torch, ops, lambda: e1.pdecode.step(e1.params, cm, mt,
                                                with_stats=True))
    err = float((mgot.float() - mwant.float()).abs().max())
    tol = 2e-4 * float(mwant.float().abs().max())
    mamba["mesh_1x4"] = {"host_ms": s * 1e3, "device_ms": dev_s * 1e3,
                         "device_launches": dev_n, "launches": ln1,
                         "max_abs_diff": err, "tokens_equal": same}
    log(f"  (1, 4) step: host {s * 1e3:.2f} ms, device {dev_s * 1e3:.3f} ms "
        f"in {dev_n} device launches; launches {ln1}; max |d| {err:.4e} "
        f"(tol {tol:.4e})")
    require(err <= tol, "the paired Mamba step on the mesh disagrees")
    kernels = ("gemv_paired_stacked", "dwconv1d", "shared_gemv")
    require({k: ln1.get(k) for k in kernels} == {k: ln.get(k)
                                                  for k in kernels},
            f"the mesh step's launches {ln1} differ from the unsharded {ln}")
    out["mamba"] = mamba
    report["mesh_serving"] = out
    del e1, dec, mparams, c0, cm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------------
# phase 23: the Mamba-based families and training on a mesh
# ----------------------------------------------------------------------------


def _placed_draw(torch, specs, seed, mesh, rules=None):
    """``device_params(specs, seed)`` placed on ``mesh`` leaf by leaf, each
    whole leaf dropped as soon as its blocks exist, so the whole tree and
    the placed one are never both resident beyond one leaf."""
    from repro_torch.nn.module import Placed, shardings

    whole = device_params(torch, specs, seed)
    places = shardings(specs, mesh, rules)

    def walk(tree, pl):
        out = {}
        for k in list(tree):
            v = tree.pop(k)
            out[k] = walk(v, pl[k]) if isinstance(v, dict) \
                else Placed.place(v, pl[k])
            del v
        return out

    return walk(whole, places)


def _joined(t):
    from repro_torch.nn.module import Placed

    return t.join() if isinstance(t, Placed) else t


def _mesh_zamba2(torch, report, out):
    """(a): zamba2-7b at full width and depth on each of
    ``ZAMBA_MESHES``: phase 17's weights (seed 500) drawn and placed leaf
    by leaf, its 4 x 192 prompt prefilled and its 8 tokens fed, each
    step's logits against phase 17's unsharded ones (``ZAMBA_MESH_TOL``,
    the argmax equal or a near-tie); bytes a device of parameters and
    cache, the prefill's and the steps' host ms, a step's device ms and
    device launches, the peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    hand = _HANDOFF.get("zamba2")
    require(hand is not None, "phase 17's unsharded zamba2 run is missing")
    cfg = get_config("zamba2-7b")
    model = build_model(cfg)
    V = cfg.vocab
    rec = {"unsharded": {k: hand[k] for k in (
        "prefill_s", "median_step_s", "step_device_s", "step_device_launches",
        "param_bytes", "cache_bytes")}}
    for shape in ZAMBA_MESHES:
        tag = f"({shape[0]}, {shape[1]})"
        mesh = _card_host_mesh(torch, shape)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = _placed_draw(torch, model.param_specs(), 500, mesh)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        prefill = make_prefill_step(cfg, mesh)
        step = make_decode_step(cfg, mesh)
        errs, secs = [], []
        with torch.no_grad():
            prompt = hand["prompt"].cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompt})
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            errs.append(_logits_agree(
                torch, f"zamba2 {tag} prefill of {B} x {REPLAY_PROMPT}",
                logits[:, :V], hand["logits"][0].cuda(), near_tie=True,
                rel=ZAMBA_MESH_TOL))
            for i, fed in enumerate(hand["tokens"]):
                tok = torch.tensor(fed, device="cuda")[:, None]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = step(params, cache, tok)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                errs.append(_logits_agree(
                    torch, f"zamba2 {tag} decode step {i}", logits[:, :V],
                    hand["logits"][i + 1].cuda(), near_tie=True,
                    rel=ZAMBA_MESH_TOL))
            tok = logits[:, :V].argmax(-1)[:, None]
            timed = _mesh_timed(torch, lambda: step(params, cache, tok),
                                f"zamba2 {tag} decode step")
        pgb, cgb = _per_device_gb(params), _per_device_gb(cache)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(secs)
        log(f"zamba2-7b on {tag}: placed in {place_s:.1f} s; a device holds "
            f"{pgb:.3f} GB of parameters (whole {hand['param_bytes'] / 1e9:.3f})"
            f" and {cgb:.4f} GB of cache (whole "
            f"{hand['cache_bytes'] / 1e9:.4f}); prefill {pre_s * 1e3:.1f} ms "
            f"(unsharded {hand['prefill_s'] * 1e3:.1f}); steps "
            + ", ".join(f"{x * 1e3:.1f}" for x in secs)
            + f" ms (median {med * 1e3:.1f}, unsharded "
            f"{hand['median_step_s'] * 1e3:.1f}); device "
            f"{timed['device_ms']:.3f} ms in {timed['device_launches']} "
            f"launches (unsharded {hand['step_device_s'] * 1e3:.3f} ms in "
            f"{hand['step_device_launches']}); peak {peak / 2**30:.2f} GiB; "
            f"max |d| {max(errs):.4e}")
        rec[str(shape)] = {"param_gb_per_device": pgb,
                           "cache_gb_per_device": cgb, "place_s": place_s,
                           "prefill_s": pre_s, "step_seconds": secs,
                           "median_step_s": med, "timed_step": timed,
                           "peak_bytes": peak, "max_abs_err": errs}
        del params, cache, logits, prompt, step, prefill
        gc.collect()
        torch.cuda.empty_cache()
    out["zamba2"] = rec


def _mesh_convert(torch, ops, out):
    """(b): mamba2-130m's paired full-width conversion
    ``convert_mamba_decode(ctx=)`` on parameters placed on
    ``CONVERT_MESH`` (calibrated through the per-shard bodies) against the
    unsharded conversion: the scales (their largest distance in float32
    ulps), the conv scale, the integrity records, and one B = 4 step of
    each, the mesh's within 2e-4 of the unsharded largest logit with its
    counters equal.  Returns the step's kernel launches."""
    import numpy as np

    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.launch.steps import make_ctx
    from repro_torch.nn.module import materialize, place, shardings

    cfg, params, whole = _mamba_bundle(torch, True)
    model = whole.model
    mesh = _card_host_mesh(torch, CONVERT_MESH)
    ctx = make_ctx(mesh, None, decode=True)
    placed = place(params, shardings(model.param_specs(), mesh))
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    t = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = convert_mamba_decode(model, placed, calib, ctx=ctx, paired=True,
                               head="shared", timings=t, device="cuda")
    conv_s = time.perf_counter() - t0
    ws, gs = whole.pcilt["proj"]["scales"], dec.pcilt["proj"]["scales"]
    ulps = 0
    for k in ws:
        a, b = ws[k].float().numpy(), gs[k].float().numpy()
        ulps = max(ulps, int(np.abs(a.view(np.int32).astype(np.int64)
                                    - b.view(np.int32).astype(np.int64))
                             .max()))
    rel = max(float(((gs[k] - ws[k]).abs() / ws[k].abs()).max())
              for k in ws)
    conv_same = dec.pcilt["scale"] == whole.pcilt["scale"]
    records = dec.pcilt["integrity"] == whole.pcilt["integrity"]
    rng = np.random.default_rng(5)
    cache = materialize(model.cache_specs(B), 5, device="cuda")
    for leaf in cache["layers"].values():
        leaf.copy_(torch.from_numpy(0.1 * rng.normal(
            size=tuple(leaf.shape)).astype(np.float32)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).cuda()
    pc = place(cache, shardings(model.cache_specs(B), mesh))
    with torch.no_grad():
        want, _, wst = whole.step(params, cache, tok, with_stats=True)
        ops.reset_launches()
        got, _, gst = dec.step(placed, pc, tok, with_stats=True)
        torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-4 * float(want.float().abs().max())
    counts = all(torch.equal(gst[g]["count"], wst[g]["count"])
                 for g in ("in", "conv", "out"))
    log(f"mamba2-130m convert_mamba_decode(ctx=) on {CONVERT_MESH} "
        f"(placed parameters, paired, act_bits 2): {conv_s:.1f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in t.items())}); projection "
        f"scales within {ulps} float32 ulps of the unsharded conversion's "
        f"(rel {rel:.2e}), conv scale equal {conv_same}, integrity records "
        f"equal {records}; a step max |d| {err:.3e} (tol {tol:.3e}), "
        f"counters equal {counts}, launches {launches}")
    require(rel <= 1e-4, f"the conversion under a ctx moved its scales by "
            f"{rel:.2e}")
    require(err <= tol and counts, "the conversion under a ctx serves other "
            "logits or counters than the unsharded one")
    require(launches == {"gemv_paired_stacked": 144, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"the mesh step of the converted bundle launched {launches}")
    out["convert"] = {"mesh": CONVERT_MESH, "seconds": conv_s,
                      "timings": t, "scale_ulps": ulps, "scale_rel": rel,
                      "conv_scale_equal": conv_same,
                      "records_equal": records, "step_max_abs_err": err,
                      "step_tol": tol, "counters_equal": counts,
                      "launches": launches}
    del dec, whole, params, placed, cache, pc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_pcilt_block(torch, ops, out):
    """(c): one mamba2-130m layer's full-sequence ``mamba_block(pcilt=,
    return_calib=True, ctx=)`` on ``CONVERT_MESH`` at full width (phase
    9's [4, 2048, 768] input and 4-bit conv tables built per channel
    shard, [448, 65536] a device): kernel 2 once a channel shard (CAUSAL,
    the tiled design), each launch against its plain version on its own
    block (outputs and counters exact), the counters summed and maxed
    into the unsharded signal's, the block within 2e-4 of the unsharded
    block's largest output, the absmaxes equal; each launch's device
    time (over the launches its profile saw).  Returns the block's
    launches."""
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.core.quantization import QuantSpec, scale_from_amax
    from repro_torch.launch.steps import make_ctx
    from repro_torch.nn import ssm
    from repro_torch.nn.layers import dense
    from repro_torch.nn.module import Placed, materialize, place, shardings

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    k = cfg.ssm.conv_kernel
    params = materialize(ssm.mamba_spec(cfg), 21, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(B, CONV_T, cfg.d_model, generator=gen, device="cuda")
    mesh = _card_host_mesh(torch, CONVERT_MESH)
    ctx = make_ctx(mesh)
    placed = place(params, shardings(ssm.mamba_spec(cfg), mesh))
    seen = []
    real = ssm.pcilt_depthwise_conv1d

    def spy(xs, w, spec, scale, **kw):
        res = real(xs, w, spec, scale, **kw)
        seen.append((xs, kw["tables"], spec, scale, res))
        return res

    with torch.no_grad():
        _, calib = ssm.mamba_block(params, cfg, x, return_calib=True)
        scale = float(scale_from_amax(calib["conv_in"],
                                      QuantSpec(4, symmetric=True)))
        pc = ssm.build_pcilt_conv(params, cfg, scale)
        want, wcal = ssm.mamba_block(params, cfg, x, pcilt=pc,
                                     return_calib=True)
        pcp = ssm.build_pcilt_conv(placed, cfg, scale)
        tabs = pcp["tables"]
        require(isinstance(tabs, Placed) and all(
            t.shape[0] == tabs.shape[0] // CONVERT_MESH[1]
            for t in tabs.blocks.values()),
            "the placed conv tables are not cut per channel shard")
        xs = ctx.split_rows(x)
        ops.reset_launches()
        with mock.patch.object(ssm, "pcilt_depthwise_conv1d", spy):
            got, gcal = ssm.mamba_block(placed, cfg, xs, pcilt=pcp,
                                        return_calib=True, ctx=ctx)
        torch.cuda.synchronize()
        launches = {k_: v for k_, v in ops.LAUNCHES.items() if v}
        designs = dict(ops.DWCONV_VARIANT_LAUNCHES)
        got = ctx.join_rows(got)
        exact, count, ratio = [], 0, 0.0
        for seg, tab, spec, sc, (y, c, r) in seen:
            yp, cp, rp = ops.dwconv1d_plain(F.pad(seg, (0, 0, k - 1, 0)),
                                            tab, spec, sc, k,
                                            with_stats=True)
            exact.append(bool(torch.equal(y, yp)) and int(c) == int(cp)
                         and float(r) == float(rp))
            count += int(c)
            ratio = max(ratio, float(r))
        _, _, stats, _ = ssm._mamba_mesh(placed, cfg, ctx, xs, pcilt=pcp)
        xbc = torch.cat([dense(params[n], x, cfg.dtype)
                         for n in ("wx", "wB", "wC")], -1)
        _, wc, wr = ops.dwconv1d_plain(F.pad(xbc, (0, 0, k - 1, 0)),
                                       pc["tables"], pc["spec"], scale, k,
                                       with_stats=True)
        prof = fullest_profile(torch, lambda: ssm.mamba_block(
            placed, cfg, xs, pcilt=pcp, ctx=ctx))
    dw = [(c, t) for key, (c, t) in prof.items()
          if DWCONV_TILED_KERNEL in key]
    dw_n, dw_us = sum(c for c, _ in dw), sum(t for _, t in dw)
    err = float((got - want).abs().max())
    tol = 2e-4 * float(want.abs().max())
    same_calib = all(torch.equal(gcal[n], wcal[n]) for n in wcal)
    sums = count == int(wc) == int(stats["conv"][0]) and \
        ratio == float(wr) == float(stats["conv"][1])
    log(f"mamba_block(pcilt=, ctx=) on {CONVERT_MESH} at full width: "
        f"launches {launches}, designs {designs}, each launch exact against "
        f"its plain version {exact}; counters {count} / ratio {ratio:.4f} "
        f"(the whole signal's {int(wc)} / {float(wr):.4f}); block max |d| "
        f"{err:.3e} (tol {tol:.3e}); absmaxes equal {same_calib}; kernel 2 "
        f"{dw_us / max(dw_n, 1):.2f} us a launch over {dw_n} launches")
    n = CONVERT_MESH[1]
    require(launches == {"dwconv1d": n} and designs == {"tiled": n,
                                                        "direct": 0},
            f"the mesh block launched {launches}, designs {designs}")
    require(len(exact) == n and all(exact),
            f"a shard's kernel-2 launch disagrees with its plain version: "
            f"{exact}")
    require(sums, "the shards' counters do not sum to the whole signal's")
    require(err <= tol, "the mesh block disagrees with the unsharded block")
    # the launches are counted above; a profile late in a run can lose a
    # record (PERF.md §7), so it only times the launches it saw
    require(dw_n >= 1, "the block's profile shows no kernel-2 launch")
    out["pcilt_block"] = {"mesh": CONVERT_MESH, "launches": launches,
                          "designs": designs, "exact": exact,
                          "count": count, "ratio": ratio,
                          "max_abs_err": err, "tol": tol,
                          "calib_equal": same_calib,
                          "dwconv_us_per_launch": dw_us / max(dw_n, 1),
                          "dwconv_launches_profiled": dw_n}
    del params, placed, pc, pcp, seen, x, xs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_train_one(torch, cfg, shape, args, what, want, box=None):
    """``launch.train.run`` on a mesh of ``shape``: its losses against the
    unsharded run's ``want`` (``MESH_TRAIN_TOL``), the median step, the
    peak; then one step from the run's state profiled (device ms and
    launches).  Returns the record and the run's result."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, cosine_schedule

    mesh = _card_host_mesh(torch, shape)
    res, _, peak = train_run(torch, cfg, args, what, box=box, mesh=mesh)
    losses = res["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    med = statistics.median(res["step_seconds"][1:])
    ocfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps),
                       weight_decay=0.01)
    step = make_train_step(cfg, mesh, ocfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(args.steps).items()}
    # one profile (a train step on a mesh takes 0.5-1.5 s)
    dev_s, dev_n, top = step_profile(
        torch, lambda: step(res["params"], res["opt"], batch), tries=1)
    log(f"{what} on {shape}: losses {[round(l, 4) for l in losses]} "
        f"(unsharded {[round(l, 4) for l in want]}, largest rel "
        f"{rel:.2e}); median step {med * 1e3:.1f} ms; one step "
        f"{dev_s * 1e3:.2f} ms of device time in {dev_n} launches; peak "
        f"{peak / 2**30:.2f} GiB")
    require(len(losses) == len(want) and rel <= MESH_TRAIN_TOL,
            f"{what} on {shape}: losses {losses} against {want}")
    rec = {"mesh": shape, "losses": losses, "unsharded_losses": want,
           "max_rel": rel, "step_seconds": res["step_seconds"],
           "median_step_s": med, "step_device_s": dev_s,
           "step_device_launches": dev_n, "peak_bytes": peak, "top": top}
    return rec, res, step, batch


def _mesh_trainings(torch, report, out):
    """(d) and (e): qwen3-0.6b ``--full`` on (2, 2), mamba2-130m on (1,
    2) and zamba2-7b cut to ``ZAMBA_TRAIN_LAYERS`` on (1, 2), each for
    ``MESH_TRAIN_STEPS`` steps of phase 14's (17's) recipe and batches
    against the unsharded run's first losses; on qwen3's (2, 2) state one
    ``explicit_rs=True`` step against the default step, and a save of the
    state (its joined leaves) with an elastic ``restore(shardings=)`` onto
    ``ELASTIC_MESH``, bit-equal."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import shardings
    from repro_torch.optim import AdamWConfig, cosine_schedule

    root = os.path.join(ROOT, "build", "smoke_mesh_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    steps = MESH_TRAIN_STEPS
    tr = out["train"] = {}

    # qwen3-0.6b --full on (2, 2)
    cfg = get_config("qwen3-0.6b")
    args = train_args(steps=steps, ckpt_dir=os.path.join(root, "q"))
    want = report["training"]["qwen3_full"]["losses"][:steps]
    rec, res, step, batch = _mesh_train_one(
        torch, cfg, TRAIN_MESHES["qwen3-0.6b"], args, "qwen3-0.6b train",
        want, box=[_to_card(_HANDOFF.pop("qwen3_init"))])
    mesh = _card_host_mesh(torch, TRAIN_MESHES["qwen3-0.6b"])
    ocfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps),
                       weight_decay=0.01)
    rs = make_train_step(cfg, mesh, ocfg, explicit_rs=True)
    a_p, _, a_m = step(res["params"], res["opt"], batch)
    b_p, _, b_m = rs(res["params"], res["opt"], batch)
    diff = max(float((_joined(x).float() - _joined(y).float()).abs().max())
               for x, y in zip(tree_leaves(a_p), tree_leaves(b_p)))
    la, lb = float(a_m["loss"]), float(b_m["loss"])
    log(f"qwen3-0.6b on (2, 2): an explicit_rs step's loss {lb:.6f} against "
        f"the default step's {la:.6f}; new parameters max |d| {diff:.3e}")
    require(abs(la - lb) <= MESH_TRAIN_TOL * abs(la),
            "the explicit_rs step disagrees with the default step")
    rec["explicit_rs"] = {"loss": lb, "default_loss": la,
                          "param_max_abs_diff": diff}
    del a_p, b_p, a_m, b_m, rs
    gc.collect()
    torch.cuda.empty_cache()
    # the (2, 2) state saved and restored elastically onto ELASTIC_MESH
    state = {"params": res["params"], "opt": res["opt"]}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        tree_map(_joined, state)))
    free = shutil.disk_usage(ROOT).free
    require(free > 2.5 * nbytes, f"{free / 1e9:.1f} GB free on disk for a "
            f"{nbytes / 1e9:.1f} GB checkpoint")
    ckpt = Checkpointer(os.path.join(root, "full"), keep=1)
    t0 = time.perf_counter()
    ckpt.save_async(steps, state, extra={"arch": cfg.name})
    snap_s = time.perf_counter() - t0
    ckpt.wait()
    write_s = time.perf_counter() - t0
    new = _card_host_mesh(torch, ELASTIC_MESH)
    specs = build_model(cfg).param_specs()
    sh = {"params": shardings(specs, new),
          "opt": {"count": None, "m": shardings(specs, new),
                  "v": shardings(specs, new)}}
    t0 = time.perf_counter()
    got_step, got, _ = ckpt.restore_latest(tree_map(lambda _: None, state),
                                           sh, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = got_step == steps and all(
        torch.equal(_joined(a), _joined(b))
        for a, b in zip(tree_leaves(got), tree_leaves(state)))
    spec = got["params"]["embed"]["embedding"].spec
    log(f"the (2, 2) state ({nbytes / 1e9:.2f} GB): host snapshot "
        f"{snap_s:.1f} s, written in {write_s:.1f} s; restored onto "
        f"{ELASTIC_MESH} in {restore_s:.1f} s (sha256 included), the "
        f"embedding's spec {spec}; bit-equal {same}")
    require(same, "the elastic restore differs from the saved state")
    rec["checkpoint"] = {"bytes": nbytes, "snapshot_s": snap_s,
                         "write_s": write_s, "restore_s": restore_s,
                         "restored_onto": ELASTIC_MESH, "equal": same}
    tr["qwen3-0.6b"] = rec
    del state, got, res, step, batch
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-130m on (1, 2)
    mcfg = get_config("mamba2-130m")
    rec, res, _, _ = _mesh_train_one(
        torch, mcfg, TRAIN_MESHES["mamba2-130m"],
        train_args(arch="mamba2-130m", steps=steps,
                   ckpt_dir=os.path.join(root, "m")), "mamba2-130m train",
        report["training"]["mamba_full"]["losses"][:steps])
    tr["mamba2-130m"] = rec
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # zamba2-7b cut to ZAMBA_TRAIN_LAYERS on (1, 2), phase 17's weights
    zcfg = get_config("zamba2-7b")
    zt = report["hybrid"]["train"]
    ccfg = dataclasses.replace(zcfg, n_layers=zt["layers"])
    full = device_params(torch, build_model(zcfg).param_specs(), 500)
    box = [_layers_cut(torch, full, zt["layers"])]
    del full
    gc.collect()
    torch.cuda.empty_cache()
    rec, res, _, _ = _mesh_train_one(
        torch, ccfg, TRAIN_MESHES["zamba2-7b"],
        train_args(arch=zcfg.name, steps=steps, seq=zt["seq"],
                   batch=zt["batch"],
                   ckpt_dir=os.path.join(root, "z")),
        f"zamba2 train ({zt['layers']} layers)", zt["losses"][:steps],
        box=box)
    tr["zamba2-7b"] = rec
    del res, box
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def mesh_training(torch, ops, report):
    """The Mamba-based families and training on a mesh, every mesh device
    ``cuda:0`` (the shards' cost, not a gain):

    (a) zamba2-7b at full width and depth (81 blocks, 7.03 B float32
        parameters) on (1, 2) and (1, 4): phase 17's weights and 4 x 192
        prompt, a prefill and 8 decode steps fed phase 17's tokens, each
        step's logits against phase 17's unsharded ones (the argmax equal
        or a near-tie); bytes a device, host and device ms and launches
        beside phase 17's;
    (b) mamba2-130m's paired conversion under a ctx on placed parameters
        (1, 4) against the unsharded conversion (scales, records, a step);
    (c) the full-sequence PCILT block under the ctx: kernel 2 once a
        channel shard, each launch exact against its plain version;
    (d) training on meshes: qwen3-0.6b ``--full`` on (2, 2), mamba2-130m
        on (1, 2), zamba2-7b at ``ZAMBA_TRAIN_LAYERS`` on (1, 2), each
        against the unsharded run's losses (1e-2), one ``explicit_rs``
        step against the default step;
    (e) the (2, 2) state saved and restored onto (1, 4), bit-equal.

    Returns the launches of (b)'s step and (c)'s block."""
    out = {}
    launches = {}
    _mesh_zamba2(torch, report, out)
    for part in (_mesh_convert, _mesh_pcilt_block):
        for k, v in part(torch, ops, out).items():
            launches[k] = launches.get(k, 0) + v
    _mesh_trainings(torch, report, out)
    report["mesh_training"] = out
    return launches


# ----------------------------------------------------------------------------
# phase 24: expert parallelism and the compressed reduction
# ----------------------------------------------------------------------------


def _dropfree(cfg):
    """``cfg`` with the least capacity factor at which no expert drops an
    entry (``n_experts / top_k``: a shard's capacity is its token count)."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _expert_bytes(tree):
    """Bytes each mesh coordinate holds of a placed tree's expert leaves
    (GB; equal on every coordinate, else the phase fails)."""
    from repro_torch.nn.module import Placed

    per = {}
    for l, sub in tree["blocks"].items():
        for n, leaf in sub.get("moe", {}).items():
            if n != "router" and isinstance(leaf, Placed):
                for c, b in leaf.device_bytes().items():
                    per[c] = per.get(c, 0) + b
    require(len(set(per.values())) == 1,
            f"the expert leaves' bytes differ between devices: {per}")
    return next(iter(per.values())) / 1e9


def _dropped_log(tmoe, cfg, log_):
    """Per layer: ``{shard: entries dropped}`` of each recorded route (the
    shard ``None`` unsharded)."""
    return [tmoe.dropped_entries(cfg, r) for r in log_]


def _ep_serving(torch, report, out):
    """(a) and (b): granite at full width and depth on ``EP_MESHES``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.nn import moe as tmoe
    from repro_torch.nn.module import spec_bytes

    cfg = get_config("granite-moe-3b-a800m")
    free = _dropfree(cfg)
    model = build_model(cfg)
    specs = model.param_specs()
    t0 = time.perf_counter()
    whole = device_params(torch, specs, 300)  # phase 16's weights
    torch.cuda.synchronize()
    moe = specs["blocks"]["sub0"]["moe"]
    eb = sum(spec_bytes(v) for k, v in moe.items() if k != "router")
    log(f"granite-moe-3b-a800m drawn in {time.perf_counter() - t0:.1f} s "
        f"(phase 16's seed): parameters {spec_bytes(specs) / 1e9:.3f} GB, "
        f"experts {eb / 1e9:.3f} GB; drop-free capacity factor "
        f"{free.moe.capacity_factor:g} (published "
        f"{cfg.moe.capacity_factor:g})")
    out["whole_gb"] = {"params": spec_bytes(specs) / 1e9,
                       "experts": eb / 1e9}
    u16 = report["moe"]["engine"]
    out["phase16_step"] = {"host_ms": u16["step_host_s"] * 1e3,
                           "device_ms": u16["step_device_s"] * 1e3,
                           "device_launches": u16["step_device_launches"]}
    gen = torch.Generator().manual_seed(24)
    prompt = torch.randint(0, cfg.vocab, (B, REPLAY_PROMPT),
                           generator=gen).cuda()
    with torch.no_grad():
        pre0 = make_prefill_step(free)
        want_pre, wc = pre0(whole, {"tokens": prompt})
        ntok = want_pre.argmax(-1)[:, None]
        dec0 = make_decode_step(free)
        want_dec = dec0(whole, wc, ntok)[0]
        out["unsharded_prefill"] = _mesh_timed(
            torch, lambda: pre0(whole, {"tokens": prompt}),
            f"unsharded {B} x {REPLAY_PROMPT} prefill (drop-free)")
        with tmoe.recording_routes() as lg:
            make_prefill_step(cfg)(whole, {"tokens": prompt})
    whole_drop = [d[None] for d in _dropped_log(tmoe, cfg, lg)]
    cap = tmoe.moe_capacity(cfg, B * REPLAY_PROMPT)
    log(f"  published factor, unsharded: capacity {cap}; dropped by layer "
        f"{whole_drop} (sum {sum(whole_drop)} of "
        f"{B * REPLAY_PROMPT * cfg.moe.top_k} a layer)")
    out["unsharded_dropped"] = whole_drop
    del wc, lg
    for shape in EP_MESHES:
        name = f"{shape[0]}x{shape[1]}"
        mesh = _card_host_mesh(torch, shape)
        t0 = time.perf_counter()
        eng = Engine(cfg, 256, B, mesh, params=whole, seed=0)
        torch.cuda.synchronize()
        row = {"setup_s": time.perf_counter() - t0,
               "params_gb_per_device": _per_device_gb(eng.params),
               "experts_gb_per_device": _expert_bytes(eng.params),
               "cache_gb_per_device": _per_device_gb(eng.cache),
               "replicated_leaves": len(eng.replicated_leaves)}
        log(f"mesh {name}: placed in {row['setup_s']:.1f} s; a device holds "
            f"{row['params_gb_per_device']:.3f} GB of parameters "
            f"({row['experts_gb_per_device']:.3f} GB of experts) and "
            f"{row['cache_gb_per_device']:.3f} GB of cache (checked by the "
            f"engine); {row['replicated_leaves']} leaves replicated by the "
            f"fallback {sorted(set(eng.replicated_leaves))}")
        served = shape == EP_SERVED  # the others' steps are timed below
        if served:
            reqs = make_requests(cfg, 4, 8, seed=0)
            st = eng.run(reqs)
            row["engine_wall_s"] = st["wall_s"]
            row["median_engine_step_ms"] = \
                statistics.median(eng.step_seconds) * 1e3
            row["tokens"] = [r.out for r in reqs]
            row["tokens_equal_phase16"] = row["tokens"] == u16["outputs"]
            log(f"  served {st['served']}/4 in {st['wall_s']:.2f} s (median "
                f"step {row['median_engine_step_ms']:.2f} ms); tokens equal "
                f"to phase 16's unsharded engine "
                f"{row['tokens_equal_phase16']}")
            require(st["served"] == 4 and st["restarts"] == 0 and all(
                len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), f"mesh {name}: the engine's requests")
        toks = torch.from_numpy(eng.tokens).cuda()
        with torch.no_grad():  # the engine's steps warmed it, if served
            row["step"] = _mesh_timed(
                torch, lambda: eng.decode(eng.params, eng.cache, toks),
                f"{name} B = {B} step (psum; phase 16 unsharded: host "
                f"{out['phase16_step']['host_ms']:.2f} ms, device "
                f"{out['phase16_step']['device_ms']:.3f} ms in "
                f"{out['phase16_step']['device_launches']} launches)",
                warm=not served)
            pre = make_prefill_step(free, mesh)
            got, gc_ = pre(eng.params, {"tokens": prompt})
            row["prefill"] = _mesh_timed(
                torch, lambda: pre(eng.params, {"tokens": prompt}),
                f"{name} {B} x {REPLAY_PROMPT} prefill (all-to-all)",
                warm=False)
            row["prefill"]["max_abs_diff"] = _logits_agree(
                torch, f"{name} prefill against the unsharded", got,
                want_pre, near_tie=True, rel=1e-2)
            # (a)'s step times the psum schedule; this one is checked
            got = make_decode_step(free, mesh)(eng.params, gc_, ntok)[0]
            row["decode"] = {"max_abs_diff": _logits_agree(
                torch, f"{name} decode from its cache (psum) against the "
                f"unsharded", got[:, :cfg.vocab],
                want_dec[:, :cfg.vocab], near_tie=True, rel=1e-2)}
            del gc_
            with tmoe.recording_routes() as lg:
                make_prefill_step(cfg, mesh)(eng.params, {"tokens": prompt})
        per = _dropped_log(tmoe, cfg, lg)
        row["dropped"] = [{f"{c[0]}.{c[1]}": n for c, n in d.items()}
                          for d in per]
        sums = [sum(d.values()) for d in per]
        log(f"  published factor, per-shard capacity "
            f"{tmoe.moe_capacity(cfg, B * REPLAY_PROMPT // shape[1] // shape[0])}"
            f": dropped by layer, per shard (row.shard) {row['dropped']}; "
            f"sums {sums} (unsharded {whole_drop})")
        out["meshes"][name] = row
        del eng, lg
        gc.collect()
        torch.cuda.empty_cache()
    del whole
    gc.collect()
    torch.cuda.empty_cache()


def _ep_train_one(torch, cfg, shape, init, what):
    """``launch.train.run`` of ``cfg`` for ``EP_TRAIN_STEPS`` steps from the
    host tree ``init`` (copied to the card), on a mesh of ``shape`` (None:
    unsharded); then one step from its state profiled.  Returns the
    record."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, cosine_schedule

    args = train_args(arch=cfg.name, steps=EP_TRAIN_STEPS,
                      ckpt_dir=os.path.join(ROOT, "build", "smoke_ep_ckpt"))
    mesh = None if shape is None else _card_host_mesh(torch, shape)
    res, text, peak = train_run(torch, cfg, args, what,
                                box=[_to_card(init)], mesh=mesh)
    ocfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps),
                       weight_decay=0.01)
    step = make_train_step(cfg, mesh, ocfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(args.steps).items()}
    prof = _profile(torch, lambda: step(res["params"], res["opt"], batch))
    if not prof:
        prof = fullest_profile(torch, lambda: step(res["params"], res["opt"],
                                                   batch))
    rec = {"mesh": shape, "layers": cfg.n_layers, "losses": res["losses"],
           "step_seconds": res["step_seconds"],
           "median_step_s": statistics.median(res["step_seconds"][1:]),
           "step_device_s": sum(t for _, t in prof.values()) / 1e6,
           "step_device_launches": sum(c for c, _ in prof.values()),
           "peak_bytes": peak,
           "aux_lines": [l for l in text.splitlines() if "load_balance" in l]}
    log(f"  {what}: losses {[round(l, 4) for l in rec['losses']]}; median "
        f"step {rec['median_step_s'] * 1e3:.1f} ms, one step "
        f"{rec['step_device_s'] * 1e3:.2f} ms of device time in "
        f"{rec['step_device_launches']} launches; peak "
        f"{peak / 2**30:.2f} GiB")
    require(len(rec["losses"]) == EP_TRAIN_STEPS and all(
        math.isfinite(l) for l in rec["losses"]), f"{what}: losses")
    del res, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _ep_training(torch, out):
    """(c): granite (drop-free) on ``EP_TRAIN_MESHES`` at the deepest of
    ``EP_TRAIN_DEPTHS`` the first mesh fits, and unsharded at that depth;
    each mesh's losses within ``MESH_TRAIN_TOL`` of the unsharded run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = _dropfree(get_config("granite-moe-3b-a800m"))
    tr = out["train"] = {"oom_layers": []}
    init = None
    for depth in EP_TRAIN_DEPTHS:
        ccfg = dataclasses.replace(cfg, n_layers=depth)
        init = _to_host(device_params(torch, build_model(ccfg).param_specs(),
                                      400 + depth))
        torch.cuda.empty_cache()
        shape = EP_TRAIN_MESHES[0]
        try:
            rec = _ep_train_one(torch, ccfg, shape, init,
                                f"granite train on {shape}, {depth} layers")
        except (torch.cuda.OutOfMemoryError, RuntimeError) as err:
            if "out of memory" not in repr(err) + repr(err.__cause__):
                raise
            del err
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  {depth} layers do not fit on {shape}; cutting")
            tr["oom_layers"].append(depth)
            continue
        tr[f"{shape[0]}x{shape[1]}"] = rec
        break
    else:
        raise SmokeFailure(f"no depth of {EP_TRAIN_DEPTHS} fits on "
                           f"{EP_TRAIN_MESHES[0]}")
    tr["layers"] = ccfg.n_layers
    want = _ep_train_one(torch, ccfg, None, init,
                         f"granite train unsharded, {ccfg.n_layers} layers")
    tr["unsharded"] = want
    for shape in EP_TRAIN_MESHES[1:]:
        tr[f"{shape[0]}x{shape[1]}"] = _ep_train_one(
            torch, ccfg, shape, init,
            f"granite train on {shape}, {ccfg.n_layers} layers")
    for shape in EP_TRAIN_MESHES:
        rec = tr[f"{shape[0]}x{shape[1]}"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(rec["losses"], want["losses"]))
        rec["max_rel"] = rel
        log(f"  {shape}: losses against the unsharded run's, largest "
            f"relative difference {rel:.2e} (gate {MESH_TRAIN_TOL:g})")
        require(rel <= MESH_TRAIN_TOL,
                f"granite training on {shape} against unsharded: {rel:.2e}")
    del init
    gc.collect()


def _to_host(tree):
    """A tree of card tensors moved to the host (the card's freed)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu()


def _ep_llama4(torch, out):
    """(d): llama4's smoke config on ``EP_LLAMA_MESHES`` on the card
    against the same mesh on the CPU (prefill, decode, the loss and its
    averaged aux); its full width's bytes a device on (1, 4) reckoned from
    the specs (nothing allocated)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.nn.module import (fallback_leaves, materialize, place,
                                       shape_structs, shardings, spec_bytes)

    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    m = build_model(cfg)
    params = materialize(m.param_specs(), 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, 16),
                         generator=torch.Generator().manual_seed(25))
    rows = out["llama4_smoke"] = {}
    for shape in EP_LLAMA_MESHES:
        runs = {}
        for dev in ("cpu", "cuda"):  # the card decodes the CPU's tokens
            d = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
            mesh = make_host_mesh(*shape, devices=[d] * (shape[0] * shape[1]))
            p = place(params, shardings(m.param_specs(), mesh))
            t = toks.to(d)
            with torch.no_grad():
                pre, cache = make_prefill_step(cfg, mesh)(p, {"tokens": t})
                nxt = runs["cpu"]["next"] if runs else \
                    pre.argmax(-1)[:, None]
                dec, _ = make_decode_step(cfg, mesh)(p, cache, nxt.to(d))
                lv, met = m.loss(p, {"tokens": t, "labels": t},
                                 ctx=make_ctx(mesh))
            runs[dev] = {"next": nxt.cpu(), "pre": pre.float().cpu(),
                         "dec": dec.float().cpu()[:, :cfg.vocab],
                         "m": [float(lv), float(met["load_balance"]),
                               float(met["router_z"])]}
        errs = {k: float((runs["cuda"][k] - runs["cpu"][k]).abs().max()
                         / runs["cpu"][k].abs().max()) for k in ("pre", "dec")}
        mrel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"]["m"],
                                                       runs["cpu"]["m"]))
        name = f"{shape[0]}x{shape[1]}"
        rows[name] = {"prefill_rel": errs["pre"], "decode_rel": errs["dec"],
                      "loss_aux_rel": mrel, "card": runs["cuda"]["m"],
                      "cpu": runs["cpu"]["m"]}
        log(f"llama4 smoke on {name}, card against CPU: prefill "
            f"{errs['pre']:.2e}, decode {errs['dec']:.2e} of the largest "
            f"logit; loss, load_balance, router_z {runs['cuda']['m']} / "
            f"{runs['cpu']['m']} (largest rel {mrel:.2e}; gate "
            f"{EP_SMOKE_TOL:g})")
        require(max(errs.values()) <= EP_SMOKE_TOL and mrel <= EP_SMOKE_TOL,
                f"llama4 smoke on {name}: the card disagrees with the CPU")
    full = get_config("llama4-maverick-400b-a17b")
    specs = build_model(full).param_specs()
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    structs = shape_structs(specs, mesh)

    def per_device(st, sp):
        if isinstance(sp, dict):
            return sum(per_device(st[k], sp[k]) for k in sp)
        return spec_bytes(sp) // math.prod(st.sharding.counts)

    moe = {k: v for k, v in specs["blocks"]["sub1"]["moe"].items()
           if k != "router"}
    dev_b = per_device(structs, specs)
    exp_b = per_device({k: structs["blocks"]["sub1"]["moe"][k] for k in moe},
                       moe)
    fb = [p for p in fallback_leaves(specs, mesh) if "/moe/" in p]
    out["llama4_full_1x4"] = {"params_gb": spec_bytes(specs) / 1e9,
                              "params_gb_per_device": dev_b / 1e9,
                              "experts_gb_per_device": exp_b / 1e9,
                              "expert_leaves_replicated": fb}
    log(f"llama4-maverick at full width, reckoned from the specs on (1, 4) "
        f"(nothing allocated): parameters {spec_bytes(specs) / 1e9:.1f} GB, "
        f"a device {dev_b / 1e9:.1f} GB, {exp_b / 1e9:.1f} GB of it experts "
        f"(one MoE layer's {spec_bytes(moe) / 24 / 1e9:.1f} GB whole); "
        f"expert leaves replicated by the fallback: {fb}")
    require(not fb, "llama4's expert leaves fall back to replication")


def _ep_compress(torch, out):
    """(e): ``compressed_pmean`` over a (4,) ``"data"`` mesh of this card,
    ``EP_COMPRESS_N`` float32 values a shard, each scheme against the exact
    mean (the reference test's gates), its host and device ms and the
    bytes the shards send, counted."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.module import Placed, TablePlacement
    from repro_torch.optim import compress

    n = EP_COMPRESS_SHARDS
    mesh = make_mesh((n,), ("data",),
                     devices=[torch.device("cuda", 0)] * n)
    g = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn((n, EP_COMPRESS_N), generator=g, device="cuda")
    px = Placed.place(x, TablePlacement(mesh, ("data", None)))
    exact = x.mean(0)
    del x
    rows = out["compress"] = {}
    for scheme, gate in (("int8", 3e-2), ("bf16", 1e-2), ("none", 1e-6)):
        stats = {}
        red, _ = compress.compressed_pmean(px, "data", scheme, stats=stats)
        sent = stats["sent_bytes"]
        got = red.blocks[(0,)]
        err = float((got - exact).abs().max() / exact.abs().max())
        del red, got
        t = _mesh_timed(torch, lambda: compress.compressed_pmean(
            px, "data", scheme), f"compressed_pmean {scheme}")
        rows[scheme] = dict(t, rel_err=err, gate=gate, sent_bytes=sent)
        log(f"  {scheme}: rel err {err:.3e} (gate {gate:g}); the shards send "
            f"{sent / 1e6:.1f} MB (counted)")
        require(err < gate, f"compressed_pmean {scheme}: {err:.3e}")
    ratio = rows["int8"]["sent_bytes"] / rows["none"]["sent_bytes"]
    out["compress_int8_over_none"] = ratio
    log(f"  int8 sends {ratio:.3f} x none's bytes (gate 0.75)")
    require(ratio < 0.75, "int8 does not cut the bytes")
    del px, exact
    gc.collect()
    torch.cuda.empty_cache()


def expert_parallel(torch, ops, report):
    """Expert parallelism on this card, every mesh device ``cuda:0`` (the
    shards' cost, not a gain):

    (a) granite-moe-3b-a800m at full width and depth (phase 16's weights,
        4.03 B float32 parameters, 14.50 GB of them experts):
        ``Engine(cfg, 256, 4, mesh)`` on ``EP_MESHES``, on ``EP_SERVED``
        serving 4 requests of 8 new tokens (every decode step the psum
        schedule); bytes a
        device (the engine checks each device's against the specs); a B =
        4 step's host ms, device ms and launches beside phase 16's;
    (b) on each mesh a 4 x 192 prefill through ``make_prefill_step(cfg,
        mesh)`` (all-to-all) and one decode step from its cache (psum) of
        the drop-free config against the unsharded steps (1e-2 of the
        largest logit, the argmax equal or a near-tie); at the published
        factor the prefill's dropped entries per layer and shard beside
        the unsharded count;
    (c) granite training (drop-free) on ``EP_TRAIN_MESHES`` and unsharded
        (``EP_TRAIN_STEPS`` steps, the deepest of ``EP_TRAIN_DEPTHS`` that
        fits), each loss within 1e-2 relative of the unsharded run's;
    (d) llama4's smoke config on ``EP_LLAMA_MESHES`` against the CPU,
        its full width's bytes a device on (1, 4) from the specs;
    (e) ``compressed_pmean`` on a (4,) ``"data"`` mesh.

    Returns the path's launches (none: the reference computes the MoE and
    the collectives outside any Pallas kernel)."""
    out = {"card_note": "every mesh device is cuda:0 (one card): the "
                        "shards' cost, not a gain", "meshes": {}}
    ops.reset_launches()
    t0 = time.perf_counter()
    _ep_serving(torch, report, out)
    out["serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ep_training(torch, out)
    out["training_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ep_llama4(torch, out)
    _ep_compress(torch, out)
    out["llama4_compress_s"] = time.perf_counter() - t0
    log(f"phase 24 parts: serving {out['serving_s']:.1f} s, training "
        f"{out['training_s']:.1f} s, llama4 and compress "
        f"{out['llama4_compress_s']:.1f} s")
    report["expert_parallel"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the expert-parallel path launched PCILT "
            f"kernels {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 25: the dry run
# ----------------------------------------------------------------------------


class DryRuns:
    """Phase 25 (a): each cell of ``DRYRUN_CELLS`` by ``python -m
    repro_torch.launch.dryrun --arch A --shape S [--multi-pod] --force``
    in a process of its own (meta tensors: no card, ``CUDA_VISIBLE_DEVICES``
    empty), started by :meth:`start` at the script's start, at most
    ``DRYRUN_WORKERS`` at a time, each niced so the script's own phases
    keep their cores; its output and its cell's JSON go to
    ``chiprun_out/dryrun/``.
    :meth:`stop` kills any still running."""

    def __init__(self):
        self.pending = list(DRYRUN_CELLS)
        self.procs, self.results, self.threads = [], {}, []
        self.lock = threading.Lock()
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()
        os.makedirs(os.path.join(ROOT, "chiprun_out", "dryrun"),
                    exist_ok=True)
        for _ in range(DRYRUN_WORKERS):
            t = threading.Thread(target=self._work, daemon=True)
            t.start()
            self.threads.append(t)

    def _work(self):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        while True:
            with self.lock:
                if not self.pending:
                    return
                cell = self.pending.pop(0)
            arch, shape, mp = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--force"] + \
                (["--multi-pod"] if mp else [])
            if cell in DRYRUN_DEPTHS:
                cmd += ["--depths", ",".join(map(str, DRYRUN_DEPTHS[cell]))]
            if cell in DRYRUN_VARIANTS:
                cmd += ["--variant", DRYRUN_VARIANTS[cell]]
            path = os.path.join(ROOT, "chiprun_out", "dryrun",
                                f"{arch}__{shape}__{int(mp)}.log")
            t0 = time.perf_counter()
            with open(path, "w") as f:
                p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                     stderr=subprocess.STDOUT,
                                     preexec_fn=lambda: os.nice(19))
                with self.lock:
                    self.procs.append(p)
                try:
                    rc = p.wait(timeout=DRYRUN_CELL_TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    rc = "timeout"
            self.results[cell] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                                  "ended_at_s": time.perf_counter() - self.t0,
                                  "log": os.path.relpath(path, ROOT)}
            with contextlib.suppress(OSError):
                shutil.copy(_cell_file(*cell), os.path.join(
                    ROOT, "chiprun_out", "dryrun", os.path.basename(
                        _cell_file(*cell))))

    def wait(self):
        for t in self.threads:
            t.join()
        return self.results

    def stop(self):
        with self.lock:
            self.pending.clear()
            procs = list(self.procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


#: the background dry runs, started in ``main``
_DRYRUNS = DryRuns()


def _cell_file(arch, shape, mp):
    from repro_torch.launch.dryrun import cell_path

    return cell_path(arch, shape, "pod2x16x16" if mp else "pod16x16",
                     DRYRUN_VARIANTS.get((arch, shape, mp), "base"))


def _cell_json(arch, shape, mp):
    with open(_cell_file(arch, shape, mp)) as f:
        return json.load(f)


def _dryrun_cells(out):
    """(a): wait for the background cells and check them."""
    t0 = time.perf_counter()
    results = _DRYRUNS.wait()
    out["waited_s"] = time.perf_counter() - t0
    sib = "/sys/devices/system/cpu/cpu0/topology/thread_siblings_list"
    out["host_cpus"] = os.cpu_count()
    out["cpu0_thread_siblings"] = open(sib).read().strip() \
        if os.path.exists(sib) else None
    log(f"  host: {out['host_cpus']} CPUs (cpu0's thread siblings "
        f"{out['cpu0_thread_siblings']}); {DRYRUN_WORKERS} dry-run processes "
        f"at nice 19 beside the script")
    rows = out["cells"] = {}
    for cell in DRYRUN_CELLS:
        arch, shape, mp = cell
        name = f"{arch} {shape} {'pod2x16x16' if mp else 'pod16x16'}" + (
            f" {DRYRUN_VARIANTS[cell]}" if cell in DRYRUN_VARIANTS else "")
        r = results.get(cell)
        require(r is not None and r["rc"] != "timeout",
                f"dry run {name}: no result ({r})")
        c = _cell_json(*cell)
        want = "skipped" if cell in DRYRUN_SKIPPED else "ok"
        row = {"status": c["status"], "wall_s": r["wall_s"],
               "ended_at_s": r["ended_at_s"]}
        if c["status"] == "ok":
            row.update(trace_s=c["trace_s"], memory=c["memory"],
                       flops_per_device=c["cost"]["flops_per_device"],
                       bytes_traffic_est_per_device=c["cost"][
                           "bytes_traffic_est_per_device"],
                       collective_bytes_per_device=c[
                           "collective_bytes_per_device"],
                       collectives=c["collectives"], n_ops=c["n_ops"],
                       n_moves=c["n_moves"], crossed=c["crossed"],
                       spread=c["spread"], n_chips=c["n_chips"],
                       model_flops_global=c["model_flops_global"],
                       depth=c.get("depth"), host_rss_mb=c["host_rss_mb"],
                       busiest=c["busiest"])
            log(f"  {name}: ok, mem/dev "
                f"{c['memory']['total_nonalias_bytes'] / 2**30:.2f} GiB "
                f"(arguments {c['memory']['argument_bytes'] / 2**30:.2f}, "
                f"temp {c['memory']['temp_bytes'] / 2**30:.2f}), flops/dev "
                f"{c['cost']['flops_per_device']:.4e}, coll/dev "
                f"{c['collective_bytes_per_device'] / 2**20:.1f} MiB; "
                f"{c['n_ops']} ops, {c['n_moves']} moves, crossed "
                f"{c['crossed']}; trace {c['trace_s']} s, process "
                f"{r['wall_s']:.1f} s (done {r['ended_at_s']:.0f} s in), "
                f"host RSS {c['host_rss_mb']:.0f} MB"
                + (f"; depths {c['depth']['run']} carried to "
                   f"{c['depth']['full']} (estimated: "
                   f"{', '.join(c['depth']['estimated']) or 'none'}; the "
                   f"temp bytes the {c['depth']['cut_depth']}-layer run's)"
                   if c.get("depth") else ""))
        else:
            log(f"  {name}: {c['status']} "
                f"({c.get('reason') or c.get('error')}); process "
                f"{r['wall_s']:.1f} s")
        rows[name] = row
        require(c["status"] == want, f"dry run {name}: {c['status']} "
                f"(want {want}): {c.get('error')}")
        require(c.get("crossed", 0) == 0, f"dry run {name}: "
                f"{c.get('crossed')} operations read inputs of other "
                f"coordinates unmoved")


def _dryrun_repairs(out):
    """(d): the repaired port faults at production scale, read off (a)'s
    cells: the loss on its rows, the decode's cache in place, whisper's
    kvshard decode."""
    train = _cell_json("qwen3-0.6b", "train_4k", False)
    dec = _cell_json("qwen3-0.6b", "decode_32k", False)
    kv = _cell_json("whisper-medium", "decode_32k", False)
    lo, hi = train["spread"]["flops"]
    top = train["top_buffers"][:3]
    rep = out["repairs"] = {
        "train_4k": {"flops_least": lo, "flops_busiest": hi,
                     "skew": hi / lo, "temp_bytes": train["spread"][
                         "temp_bytes"], "top_buffers": top},
        "decode_32k": {"memory": dec["memory"],
                       "temp_bytes": dec["spread"]["temp_bytes"],
                       "total_bytes": dec["spread"]["total_nonalias_bytes"],
                       "top_buffers": dec["top_buffers"][:3]},
        "whisper_kvshard": {"memory": kv["memory"],
                            "flops_per_device": kv["cost"][
                                "flops_per_device"],
                            "trace_s": kv["trace_s"]}}
    gib = 2 ** 30
    log(f"  qwen3-0.6b train_4k: flops a coordinate {lo:.4e} (least) to "
        f"{hi:.4e} (busiest), {hi / lo:.3f}x; temporaries "
        f"{train['spread']['temp_bytes'][0] / gib:.2f} to "
        f"{train['spread']['temp_bytes'][1] / gib:.2f} GiB at the cut depth;"
        f" largest buffers " + ", ".join(
            f"{b['bytes'] / gib:.3f} GiB ({b['op']})" for b in top))
    m = dec["memory"]
    log(f"  qwen3-0.6b decode_32k: {m['total_nonalias_bytes'] / gib:.2f} "
        f"GiB a device at the busiest (arguments "
        f"{m['argument_bytes'] / gib:.2f}, temporaries "
        f"{m['temp_bytes'] / gib:.2f}, aliased outputs "
        f"{m['alias_bytes'] / gib:.2f}); temporaries "
        f"{dec['spread']['temp_bytes'][0] / gib:.3f} to "
        f"{dec['spread']['temp_bytes'][1] / gib:.3f} GiB")
    m = kv["memory"]
    log(f"  whisper-medium decode_32k kvshard: ok, "
        f"{m['total_nonalias_bytes'] / gib:.2f} GiB a device (arguments "
        f"{m['argument_bytes'] / gib:.2f}, temporaries "
        f"{m['temp_bytes'] / gib:.2f}), {kv['cost']['flops_per_device']:.4e}"
        f" flops, trace {kv['trace_s']} s")
    require(hi / lo <= DRYRUN_FLOPS_SKEW, f"qwen3-0.6b train_4k: the busiest "
            f"coordinate's flops are {hi / lo:.3f}x the least loaded one's")
    require(top[0]["bytes"] < DRYRUN_MAX_BUFFER, f"qwen3-0.6b train_4k: a "
            f"{top[0]['bytes'] / gib:.2f} GiB buffer ({top[0]['op']})")
    require(dec["memory"]["total_nonalias_bytes"] < DRYRUN_DEVICE_BYTES,
            f"qwen3-0.6b decode_32k needs "
            f"{dec['memory']['total_nonalias_bytes'] / 1e9:.2f} GB a device")


def _dryrun_args(torch, cfg, kind, mesh, meta):
    """The step arguments of (b): meta ones from the specs, or the card's
    (seeded weights placed on ``mesh``, a zero cache, random tokens)."""
    from repro_torch.launch.specs import data_spec, step_args
    from repro_torch.models import build_model
    from repro_torch.nn.module import shape_structs

    model = build_model(cfg)
    specs = {"params": model.param_specs()}
    if kind == "decode":
        specs["cache"] = model.cache_specs(B, DRYRUN_CACHE)
    if meta:
        args = step_args({k: shape_structs(v, mesh, data_spec(mesh))
                          for k, v in specs.items()})
        dev = "meta"
    else:
        args = {k: (_placed_draw(torch, v, 0, mesh) if mesh is not None
                    else device_params(torch, v, 0))
                for k, v in specs.items()}
        dev = "cuda"
    gen = torch.Generator().manual_seed(25)
    if kind == "decode":
        args["cache"]["pos"] = DRYRUN_PREFILL
        args["tokens"] = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                                       dtype=torch.int32).to(dev)
    else:
        args["batch"] = {"tokens": torch.randint(
            0, cfg.vocab, (B, DRYRUN_PREFILL), generator=gen,
            dtype=torch.int32).to(dev)}
    return args


def _dryrun_vs_card(torch, out):
    """(b): the meta run against the same step counted on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import make_step, measure_step
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config("qwen3-0.6b")
    rows = out["vs_card"] = {}
    keys = ("argument_bytes", "flops", "collective_bytes")
    for shape in (None,) + DRYRUN_MESHES:
        name = "unsharded" if shape is None else f"{shape[0]}x{shape[1]}"
        n = 1 if shape is None else shape[0] * shape[1]
        meta_mesh = None if shape is None else \
            make_host_mesh(*shape, devices=["meta"] * n)
        card_mesh = None if shape is None else _card_host_mesh(torch, shape)
        for kind in ("decode", "prefill"):
            t0 = time.perf_counter()
            meta = measure_step(make_step(cfg, kind, meta_mesh), kind,
                                _dryrun_args(torch, cfg, kind, meta_mesh,
                                             True), meta_mesh)
            t_meta = time.perf_counter() - t0
            args = _dryrun_args(torch, cfg, kind, card_mesh, False)
            step = make_step(cfg, kind, card_mesh)
            if shape is None and kind == "prefill":
                with torch.no_grad():
                    step(args["params"], args["batch"])  # warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            card = measure_step(step, kind, args, card_mesh)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            row = {"meta_s": t_meta, "card_s": t_card,
                   "n_ops": meta["n_ops"], "n_moves": meta["n_moves"],
                   "crossed": meta["crossed"]}
            if shape is None and kind == "prefill":
                peak = torch.cuda.max_memory_allocated() - before
                dry = meta["per_coord"]["-"]["temp_bytes"]
                row.update(dry_peak_bytes=dry, card_peak_bytes=peak,
                           card_over_dry=peak / dry)
                log(f"  unsharded prefill: dry-run peak of live bytes "
                    f"{dry / 1e9:.4f} GB, max_memory_allocated() on the "
                    f"card {peak / 1e9:.4f} GB (ratio {peak / dry:.4f})")
            del args, step
            for c, m in meta["per_coord"].items():
                k = card["per_coord"].get(c)
                require(k is not None, f"{name} {kind}: the card run has no "
                        f"coordinate {c}")
                for key in keys:
                    require(m[key] == k[key], f"{name} {kind} at {c}: {key} "
                            f"meta {m[key]} card {k[key]}")
                for kd, v in m["coll"].items():
                    require(v == k["coll"].get(kd, {"count": 0, "bytes": 0}),
                            f"{name} {kind} at {c}: {kd} meta {v} card "
                            f"{k['coll'].get(kd)}")
            require(len(meta["per_coord"]) == len(card["per_coord"]),
                    f"{name} {kind}: coordinates differ")
            require(meta["crossed"] == 0, f"{name} {kind}: {meta['crossed']} "
                    f"operations read inputs of other coordinates unmoved")
            row["per_coord"] = {c: {key: v[key] for key in keys
                                    + ("temp_bytes",)}
                                for c, v in meta["per_coord"].items()}
            rows[f"{name} {kind}"] = row
            busiest = max(meta["per_coord"].values(),
                          key=lambda v: v["flops"])
            log(f"  {name} {kind}: {len(meta['per_coord'])} coordinates "
                f"equal (argument bytes, flops, moves by kind); busiest "
                f"flops {busiest['flops']:.4e}, moves "
                f"{meta['collective_bytes_per_device'] / 1e6:.3f} MB; meta "
                f"{t_meta:.1f} s, card {t_card:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()


def _dryrun_compress(torch, out):
    """(c): the move record of ``compressed_pmean`` int8 on phase 24's
    (4,) mesh against its ``stats["sent_bytes"]``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import coords
    from repro_torch.nn.module import Placed, TablePlacement
    from repro_torch.optim import compress

    n = EP_COMPRESS_SHARDS
    mesh = make_mesh((n,), ("data",), devices=[torch.device("cuda", 0)] * n)
    g = torch.Generator(device="cuda").manual_seed(26)
    px = Placed.place(torch.randn((n, EP_COMPRESS_N), generator=g,
                                  device="cuda"),
                      TablePlacement(mesh, ("data", None)))
    stats = {}
    with coords.recording_moves() as moves:
        compress.compressed_pmean(px, "data", "int8", stats=stats)
    got = sum(e["bytes"] for e in moves)
    kinds = sorted({e["kind"] for e in moves})
    out["compress"] = {"recorded_bytes": got,
                       "sent_bytes": stats["sent_bytes"], "kinds": kinds,
                       "moves": len(moves)}
    log(f"  compressed_pmean int8: {len(moves)} moves recorded ({kinds}), "
        f"{got} bytes; stats sent_bytes {stats['sent_bytes']}")
    require(got == stats["sent_bytes"], "the move record of "
            "compressed_pmean differs from its sent_bytes")
    del px
    gc.collect()
    torch.cuda.empty_cache()


def dryrun(torch, ops, report):
    """Phase 25, the dry run (module docstring): (a) the production cells
    (run in the background since the script's start), (b) the dry run
    against the card, (c) the compressed reduction's record.  Returns the
    path's launches (none: the dry run runs no kernel, as the reference
    lowers its steps without one)."""
    out = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    _dryrun_vs_card(torch, out)
    out["vs_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _dryrun_compress(torch, out)
    out["compress_s"] = time.perf_counter() - t0
    _dryrun_cells(out)
    _dryrun_repairs(out)
    log(f"phase 25 parts: against the card {out['vs_card_s']:.1f} s, "
        f"compress {out['compress_s']:.1f} s, waited for the cells "
        f"{out['waited_s']:.1f} s")
    report["dryrun"] = out
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {}, f"the dry run launched PCILT kernels {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 26: the Hopper resource verifier
# ----------------------------------------------------------------------------


def resources(torch, ops, report):
    """Phase 26 (module docstring): ``analysis.smem`` over the full sweep
    against the built libraries and their ``ptxas`` reports.  Returns the
    path's launches (none: the verifier launches nothing)."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import autotune as atn
    from repro_torch.kernels import build

    ops.reset_launches()
    runs = atn.TIMING_RUNS
    t0 = time.perf_counter()
    libs = {n: build.library(n) for n in build.SOURCES}
    reports = {n: build.report(n) for n in build.SOURCES}
    summary = {}
    found = smem.verify_all("full", libraries=libs, reports=reports,
                            summary=summary)
    secs = time.perf_counter() - t0
    out = report["resources"] = {
        "seconds": secs, "families": {k: v for k, v in summary.items()
                                      if k not in ("report", "kernels")},
        "kernels": summary["kernels"], "report": summary["report"],
        "findings": [f.render() for f in found]}
    for fam, v in out["families"].items():
        log(f"  {fam} (kernels {v['kernels']}): {v['shapes']} shapes, "
            f"{v['launches']} launches checked, {v['refused']} shapes "
            f"refused by the wrapper")
    for lib, rep in summary["report"].items():
        for k, r in sorted(rep.items()):
            use = summary["kernels"].get(k, {})
            log(f"  {lib} {k}: {r['registers']} registers, "
                f"{r['static_smem']} B static shared memory, dynamic up to "
                f"{use.get('max_dynamic_smem', 0)} B at up to "
                f"{use.get('max_threads', 0)} threads, spills "
                f"{r['spill_stores']} / {r['spill_loads']} B, "
                f"{r['instances']} instances")
    for f in found:
        log(f"  {f.render()}")
    errors = [f for f in found if f.severity == "error"]
    log(f"  smem, full sweep: {len(found)} finding(s), {len(errors)} "
        f"error(s); {secs:.1f} s")
    require(not errors, f"the resource verifier found {len(errors)} error(s)"
            f": {errors[0].render() if errors else ''}")
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(launches == {} and atn.TIMING_RUNS == runs,
            f"the resource verifier launched kernels {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # phase 25's production cells need no card: they run from the start
    _DRYRUNS.start()
    # every phase before 18 dispatches through an empty design cache: the
    # heuristic's designs, which the phases' design counts require
    tune_root = os.path.join(ROOT, "build", "smoke_tune_main")
    os.makedirs(tune_root, exist_ok=True)
    for name in os.listdir(tune_root):
        os.remove(os.path.join(tune_root, name))
    os.environ["REPRO_PCILT_TUNE_CACHE"] = os.path.join(tune_root,
                                                        "tiles.json")
    from repro_torch import core
    from repro_torch.kernels import autotune as atn
    from repro_torch.kernels import build, ops

    atn.reset_cache()

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 oracles stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    require(clk and clk[0].replace(".", "").isdigit(),
            f"nvidia-smi gave no clocks.max.sm: {clk}")
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "sm_count": torch.cuda.get_device_properties(0)
              .multi_processor_count, "sm_clock_max_mhz": float(clk[0]),
              "checks": [], "profile_retries": []}
    log(f"{report['sm_count']} SMs, clocks.max.sm {clk[0]} MHz")

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc, {len(build.SOURCES)} "
        f"sources in parallel)")
    for name, text in build.build_log().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in build.SOURCES:
        build.library(name)

    #: the profiled windows and lost markers so far, after each stage
    report["profiles"] = {}

    def profiles_after(stage):
        report["profiles"][stage] = dict(PROFILES)
        torch.cuda.empty_cache()

    errs = check_kernels(torch, ops, core, report)
    profiles_after("check_kernels")
    check_crc_kernel(torch, ops, report, errs)
    profiles_after("check_crc_kernel")
    rows = time_kernels(torch, ops, core, report)
    profiles_after("time_kernels")
    time_slice3_kernels(torch, ops, report, rows)
    profiles_after("time_slice3_kernels")
    time_plan_kernel(torch, ops, report, rows)
    profiles_after("time_plan_kernel")
    time_conv_kernels(torch, ops, report, rows)
    profiles_after("time_conv_kernels")
    time_crc_kernel(torch, ops, report, rows, errs)
    profiles_after("time_crc_kernel")
    log(f"profiles taken again: {len(report['profile_retries'])}; windows "
        f"and lost markers after each stage: {report['profiles']}")
    # each path's launches, counted from 0 just before it runs
    launches = dict.fromkeys(ops.LAUNCHES, 0)

    report["phase_s"] = {}

    def count(phase):
        """Run one path's phase, add its launches, keep its seconds."""
        t0 = time.perf_counter()
        for k, v in phase(torch, ops, report).items():
            launches[k] += v
        report["phase_s"][phase.__name__] = time.perf_counter() - t0
        report["profiles"][phase.__name__] = dict(PROFILES)
        log(f"({phase.__name__}: {report['phase_s'][phase.__name__]:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    for phase in (serve, paper_cnn, serve_paired, paired_parity,
                  single_layers, plans_and_extensions, learnable,
                  resilience, dense_serving, training, dense_configs,
                  moe_family, hybrid_family, audio_family, vlm_family,
                  autotune_phase, sharded_tables, mesh_serving,
                  mesh_training, expert_parallel, dryrun, resources):
        count(phase)
    sh = report["sharded"]["conv4"]
    for kind in ("fused_conv2d", "shared_conv2d"):
        rows[f"{kind} conv4"]["sharded_ms"] = {
            name: sh[f"{kind} {name}"]["ms"] for name in ("D2", "D4")}
    blk = report["mesh_training"]["pcilt_block"]
    rows["window counters"].update(
        mesh_shard_launches=blk["launches"]["dwconv1d"],
        mesh_shard_us=blk["dwconv_us_per_launch"])
    step = report["serve"]["step_compare"]
    rows["window counters"].update(
        step_device_launches=step["unpaired stats"]["device_launches"],
        step_device_launches_kept=step["unpaired stats kept dwconv"][
            "device_launches"])

    primary = {"gemv_stacked": "wz,wx", "dwconv1d": "window counters",
               "shared_gemv": "head", "fused_conv2d": "fused_conv2d conv4",
               "shared_conv2d": "shared_conv2d conv4",
               "gemv_host": "gemv_host conv4",
               "conv2d_host": "conv2d_host conv4",
               "gemv_paired_stacked": "paired wz",
               "fused_gemv": "fused_gemv gate",
               "gemv_paired": "gemv_paired wz",
               "dwconv1d_host": "dwconv1d_host signal",
               "gemv_plan": "gemv_plan perm", "crc32": "crc32 layer"}
    kernels = []
    for name, key in primary.items():
        r = rows[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
        for extra in ("plain_shape", "direct_ms", "fetch_floor_ms",
                      "direct_with_fill_ms", "step_device_launches",
                      "step_device_launches_kept", "host_zlib_ms",
                      "device_launches_per_call", "sharded_ms", "kept_ms",
                      "wide",
                      "mesh_shard_launches", "mesh_shard_us"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    # kernel 9's designs on its main path (phase 9: the B = 4 MLP's split,
    # the 768-row prefill's staged)
    k9 = next(k for k in kernels if k["name"] == "fused_gemv")
    k9.update(design_launches=report["single_layers"]["mlp"]["designs"],
              staged_source=STAGED_SOURCE)
    # kernel 6 where an entry point serves it: serve_pcilt's M = 4 gate
    m4 = report["dense_rows"]["gemv_host serve_pcilt M4"]
    next(k for k in kernels if k["name"] == "gemv_host")["serve_pcilt_m4"] = {
        k: m4[k] for k in ("shape", "variant", "ms", "direct_ms",
                           "staged_ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by")}
    head = rows["crc32 head"]
    kernels[-1].update(head_shape=head["shape"], head_ms=head["ms"],
                       head_kept_ms=head["kept_ms"],
                       head_bound_ms=head["bound_ms"],
                       head_host_zlib_ms=head["host_zlib_ms"],
                       head_device_launches_per_call=head[
                           "device_launches_per_call"],
                       launches_per_tick=report["serve"]["monitor"][
                           "crc_launches_per_tick"])
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s; profiled windows "
        f"{PROFILES['windows']}, {PROFILES['first_record_lost']} of them "
        f"without their first record (a marker); markers lost "
        f"{PROFILES['markers_lost']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--autotune-warm"]:
            sys.exit(autotune_warm(sys.argv[2]))
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        _DRYRUNS.stop()  # phase 25's processes never outlive the script
