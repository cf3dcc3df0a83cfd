#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorframes_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tensorframes_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once), then runs the port's main
paths through its public entry points and checks every result:

1. the README example: ``map_blocks(x + 3)`` over 10 rows, exact;
2. the reference's end-to-end workload: ``map_blocks(z = x + x)`` over a
   20M-row double frame in 8 partitions, then the sum of ``z`` through
   ``reduce_blocks`` and through ``aggregate({"z": "sum"})`` grouped by an
   int64 key with 100,000 distinct values, against numpy f64 to rtol 1e-12;
2b. the host runtime (``native_host_20M``): ``native.available()`` (the
   library built by ``g++`` from ``csrc/host_runtime.cpp`` at first use),
   then phase 2's 20M rows: ``convert`` f64 -> f32 and int64 -> int32,
   ``gather_rows`` by a permutation, ``pad_ragged`` of 100,000 ragged
   cells (about 10M values) and ``pad_column`` of 10,000 of them, and
   phase 2's keyed ``aggregate`` in its computation form over 2M rows
   (its gather by key), each with the library and under
   ``TFT_DISABLE_NATIVE=1``, bit-equal, both walls printed;
2c. the parallel layer (``mesh_reference_workload_20M``): phase 2's rows
   on ``local_mesh()`` (the card: 1 shard) and on a mesh of 8 shards of
   the one card: ``distribute`` -> ``dmap_blocks(z = x + x)`` ->
   ``dfilter(x < 0.75)`` -> ``dreduce_blocks`` sum and min (collective)
   and min (generic) -> ``daggregate({"z": "sum"})`` by ``key`` with host
   keys, with device keys (``max_groups=131072``) and through the generic
   fold; a two-key device-key aggregate (``key % 200``, ``key // 1000``,
   ``max_groups=32768``) and a 4M-row frame where key 0 holds 80% of the
   rows (salted across the 8 shards); every result against numpy (f64
   sums rtol 1e-12, min exact), each route bit-identical across two runs,
   host keys bit-equal to device keys, segment_sum launched once per shard and
   sum column, the ``aggregate.factorize_keys`` span against the device-key
   id build (``daggregate.device_key_ids``);
2d. the shuffle (``shuffle_20M``): phase 2's 20M rows on both meshes of
   2c: ``dsort`` by ``key`` ascending and by (``key``, ``x``) descending,
   bit-equal to numpy's stable lexsort; the first under a 256 MiB ledger
   through the external sort (5 runs), bit-equal; ``daggregate({"v":
   "sum", "c": "max"})`` over 2,000,000 distinct keys (routed through
   ``shuffle_daggregate`` on 8 shards, the dense route under
   ``TFT_SHUFFLE=0`` and on one shard) against numpy, and an HLL by a
   100-valued key through the sketch route, bit-equal to ``aggregate``;
   ``join(mesh=8 shards)`` of 6M of the rows (cut from 20M) against a
   4M-row build (96 MB, over the 64 MiB broadcast limit): routed
   ``partitioned`` and bit-identical to ``broadcast_join``, routed
   ``sort_merge`` under ``TFT_SHUFFLE=0`` and on one shard, with the same
   rows in key order; one JSON line a part;
2e. the elastic mesh and the fused distributed plan (``elastic_20M``,
   :func:`phase_elastic`): phase 2's 20M rows on 8 logical shards of the
   card: (a) a device lost under each of ``dmap_blocks``, ``dfilter``,
   ``dreduce_blocks`` sum and min, ``daggregate`` with host and device keys
   and ``dsort``, each recovered onto 7 shards of the card, bit-equal to
   the healthy run (f64 sums to rtol 1e-12 of numpy), the lost shard's rows
   re-sharded, segment_sum once per surviving shard and float sum column;
   (b) the lost shard admitted back and a second frame migrated at its next
   dispatch; (c) a rebalance after synthetic persistent skew, then a
   daggregate over the unequal shards; (d) the idle layer's wall against
   ``elastic.bypass()``; (e) ``dmap -> dfilter -> dmap -> dreduce`` and
   ``dmap -> daggregate`` eager and through ``lazy()`` (4 and 2 dispatches
   against 1, no interstage host bytes, no fallback) and a device loss
   mid-stage; (f) a windowed stream folding on the mesh, one dispatch and
   8 segment_sum launches a fold. The path is traced, so each mesh op's
   shard times feed the skew tracker: 2c, 2d and every part of 2e but (c)
   must leave the layout alone (``mesh.rebalances`` unmoved);
2f. the multi-process cluster (``cluster_2x4_20M``, :func:`phase_cluster`):
   rank processes (``subprocess``, importing only the port, numpy and
   torch; :data:`CLUSTER_RANK`) joined through ``parallel.initialize``
   with ``TFT_COORDINATOR`` on a free local port, ``TFT_REQUIRE_CLUSTER=1``
   and a hard wall limit that kills every rank, each rank holding 4
   logical shards of the card, over phase 2's 20M rows split unevenly
   (11M to rank 0, 9M to rank 1, so the pads sit per process): (a) two
   ranks sharing the card under gloo run the JAX package's cluster
   worker's ten steps (``dmap_blocks`` and ``collect_frame``,
   ``dreduce_blocks`` monoid and generic, ``daggregate`` monoid with host
   keys, generic, device keys and composite device keys, ``dfilter``,
   ``dsort`` by columnsort across the processes, checkpoint save and
   resume per process), each against numpy over the global rows on both
   ranks (f64 sums to rtol 1e-12), bit-identical across the ranks, B1 on
   each rank's 4 shards; (b) a one-rank world through NCCL
   (``dreduce_blocks`` and ``daggregate`` by device keys, against numpy:
   the NCCL path's plumbing on the card, no traffic between cards); (c)
   ``backend="nccl"`` for two ranks on the one card, refused with
   ``ClusterInitError``
   naming the card within the bootstrap deadline (the outcome printed);
   (d) the ported ``analytics`` demo over 2M CSV rows on 8 logical shards
   of the card, against numpy over the file; a JSON line a part with the
   backend, rows a rank, ``shard_valid``, the step walls, the bytes
   through the host, B1's launches and the card's name and power limit;
3. the k-means centre update: ``aggregate({"f": "sum"})`` over a 2M x 64
   f32 vector column grouped by 1,024 keys, against numpy f64 to rtol 1e-5;
3b. the lazy query path from a file: the 20M-row workload written with
   pyarrow to ``build/data/`` (20 row groups of 1M rows; ``ts`` the row
   index, ``key`` in [0, 100,000), ``x``, ``y`` and two columns nothing
   reads), then ``read_parquet`` -> ``map_blocks`` of the DSL's
   ``block(x) + block(y)`` -> ``filter(ts >= 10M)`` -> ``map_rows(w = z *
   2)`` -> ``select`` -> ``aggregate({"w": "sum"})`` by ``key``, once
   through the logical plan (cold), then three times under ``TFT_FUSE=0``
   and three times fused, alternating, for their walls: the fused run
   reads 4 of 6 columns and 10 of 20 row groups, dispatches once per stage
   and non-empty block and converts host->device once per block; all
   agree bit for bit and with numpy f64 ``bincount`` to rtol 1e-12;
3c. SSB Q2.1 at scale factor 1 (the Star Schema Benchmark, O'Neil et al.,
   TPCTC 2009, schema of its section 2): lineorder (6M rows in 8
   partitions, ``lo_revenue`` integral f64) joined to date (2,556 days from
   1992-01-01), part (200,000) and supplier (2,000), categorical
   attributes as int32 codes; three broadcast joins through
   ``TensorFrame.join`` -> ``filter(p_category == MFGR#12 and s_region ==
   AMERICA)`` -> ``select`` -> ``aggregate({"lo_revenue": "sum"})`` by
   ``(d_year, p_brand1)`` -> ``order_by``: fused cold, then ``TFT_FUSE=0``
   and fused twice each, alternating, equal to a numpy int64 reference and
   bit-equal to one another; the roll-up (no filter, 7,000 groups); the
   part join as ``strategy="sort_merge"``, bit-equal after the aggregate;
   ``approx_distinct(lo_custkey)`` by ``d_yearmonthnum`` (HLL, 4,096
   registers, the device fold, 84 months whose registers all differ),
   within 5 sigma of the exact count and its registers bit-equal to the
   fold on the CPU and to the host's numpy fold. Build columns the chain
   never names (``d_yearmonthnum``, ``p_mfgr``, ``s_nation``) are never
   gathered;
3d. recovery from a real ``torch.cuda.OutOfMemoryError``: 20M rows in 8
   partitions, an f32 cell ``x`` of 16 features and an int64 key in [0,
   100,000), a ``map_rows`` of random Fourier features (``z = cos(x @ W +
   b) @ beta / sqrt(4096)``) forced by ``aggregate({"z": "sum"})`` under a
   24 GiB cap (``torch.cuda.set_per_process_memory_fraction``): each
   block's submit runs out of memory, its drain re-runs it synchronously
   and the executor halves it until it fits (3 splits a block), the keyed
   sum runs through segment_sum in f32; ``z`` bit-equal to the uncapped
   chain over the split's leaf shapes and within 1e-4 of f64 numpy, the
   sums within the f32 summation bound, the counters, trace events and
   flight records as the memory model predicts; then injected OOM,
   dispatch, drain and give-up drills, each bit-equal to the undisturbed
   run;
3e. the port under a device-memory ledger with the process capped at
   8 GiB (``memory_budget_20M``, :func:`phase_memory_budget`): proactive
   splits, pending blocks spilled, preemption parks and resumes, join
   builds spilled, faulted back and probed in chunks;
3f. the Yahoo Streaming Benchmark's advertising query as a stream
   (Chintapalli et al., IPDPSW 2016; github.com/yahoo/streaming-benchmarks):
   20M events at 100,000 a second with the benchmark's seven fields
   (string fields as integer codes), in batches of 400,000 from a
   ``GeneratorSource`` -> ``filter_rows(event_type == view)`` -> a stream
   join to the ads table (1,000 ads, 10 to a campaign) ->
   ``map_blocks(n = 1.0)`` -> ``select`` -> count per campaign per 10 s
   tumbling window (``{"n": "sum"}``, watermark delay 1 s), then a late
   batch for the first window: every (window, campaign) count equal to
   numpy's, 20 windows of 100 campaigns, the late views counted, no batch
   skipped, segment_sum launched once per batch and window; (b) with
   ``approx_distinct(user_id)`` beside it (the live windows' registers
   bit-equal to the CPU executor's fold, the estimates within 5 sigma of
   numpy's exact counts); (c) one transient ``batch`` fault (retried, not
   counted twice) and one drifted batch through a ``QueueSource``
   (skipped and counted); (d) the background pump over a bounded queue
   fed by a producer thread, with a ``SlotPool(2)`` and a
   ``ParquetSink`` whose file reads back equal;
3g. phase 3b's parquet file tailed a row group a poll
   (``ParquetTailSource``): ``{"x": "sum", "y": "max"}`` by ``key`` over
   sliding windows of 4M rows every 2M (``ts``): 11 windows, each equal
   to numpy's (sums to rtol 1e-12, maxima exactly); (b) with a 4M
   watermark delay, ``max_state_rows`` 250,000 and a ledger, and row group
   15 appended again after the last: the held windows spill to pinned
   host memory, the repeat faults them back, none is force-emitted; (c)
   the first 4 row groups through ``map_rows`` -> ``filter_rows`` ->
   ``select``, bit-equal to the batch path;
3h. shipped computations (``shipped_computation_20M``): four programs
   serialized with ``builder.save_computation`` into
   ``build/data/shipped/`` (P1 the reference workload's ``z = x + x`` in
   the DSL, P2 the row-local JL program of phase 3e closing over its
   [64, 16] f32 table made on the CPU, P3 a ``reduce_blocks`` sum, P4 a
   reduce for the computation form of ``aggregate``), then a fresh
   interpreter (``subprocess``, importing only the port, numpy and torch)
   rebuilds the data from the seeds and runs them from their files
   through the builders: P1 over phase 2's 20M rows in 8 partitions, then
   ``aggregate({"z": "sum"})`` by its 100,000 keys (8 segment_sum
   launches) and P3; P2 through ``map_rows`` over 2M x 64 f32 rows in 8
   partitions, then ``aggregate({"z": "sum"})`` by 100,000 keys (8 more);
   P4 through ``aggregate_builder`` over 2M rows at 1,024 keys (the
   segmented fold, vmapped over the placed program; no segment_sum). There, P1 loaded twice
   under a ``SharedCompileCache`` installed with
   ``set_computation_interner`` prepares one device program (hits 1,
   misses 1, ``compile_count`` 1) and a third load without it another;
   and a program serialized while the default device is the card's runs
   equal on the CPU executor and on the card. This process runs P1-P4 as
   live programs on the same data: every collected column's sha256 equal
   to the child's, the f64 sums within rtol 1e-12 of numpy f64, the f32
   JL sums within 1e-5 of each group's sum of ``|z|``, 16 launches in
   each process; the child's launches are added to the ``kernels`` line;
3i. the computation form of ``aggregate`` through the segmented fold
   (``aggregate_fold_20M``): 20M f64 rows in 8 partitions into 1,024 keys
   with ``{"v": v_input.sum(0)}`` and the norm combiner
   ``sqrt((v_input ** 2).sum(0))``, against numpy's ``bincount`` and the
   per-group ``sqrt`` of its sum of squares to rtol 1e-12; then phase
   3h's P4 shape (2M rows, 1,024 keys) through the fold and through the
   ``CompactionBuffer`` path of an executor of another kind, with both
   walls, the fold's vmapped calls and the buffer path's reduce calls;
3j. the ported demos (``kmeans_demo_2M``): k-means over 2,000,000 points
   x 64 f64 features, k = 256, 8 partitions, from ``make_data``'s
   generator (seed 1): 3 steps of variant A (``map_blocks`` assignment ->
   computation-form ``aggregate``) and 3 of variant B (segment_sum twice
   a block inside the program, 16 launches a step), then, over the frame
   distributed on ``local_mesh()``, 3 of variant C (variant B's program
   over the gathered array, 2 launches a step) and 3 of variant D
   (``daggregate(max_groups=k)``, a launch per sum column and shard a
   step), each step's centers and total distance against a numpy step by
   the matrix form of the distances to rtol 1e-9; then ``geom_mean`` and
   ``groupby_scratch`` at their demo sizes against numpy;
3k. adaptive execution (``adaptive_20M``): a row-local chain
   (``map_rows`` -> ``filter`` -> ``select``) over 20M rows in 200
   blocks of 100,000, the first forcing static, then static (``=0``) and
   re-bucketed forcings alternating (=0, adaptive, adaptive, =0; a
   coalesced unit is merged into pinned host memory when it is
   dispatched), all digests equal; a mid-plan
   re-plan on a shifted distribution (priced on a warm frame, one re-plan,
   equal to ``=0``); the same plan forced three times, the third a
   result-cache hit with 0 dispatches; the YSB query over 2M events in
   source batches of 50,000 with ``batch_rows="adaptive"`` and with 200,000
   rows, both equal to numpy's counts. Phases 3b, 3c and 3e run with
   ``TFT_ADAPTIVE=0 TFT_RESULT_CACHE=0`` (``static_plan``), so that their
   timed repeats are not cache hits and their counts are the static
   layout's; each then forces its query (3e: (b)'s chain under the same
   budget and depth) once more at =0 and twice with both knobs at their
   default, on (``default_forcings``), every digest equal to the =0 one;
3l. serving three tenants (``serve_three_tenants_20M``,
   :func:`phase_serve_three_tenants`) through ``serve.QueryScheduler``,
   every query ending in a keyed ``aggregate`` through segment_sum, with
   ``TFT_RESULT_CACHE=0``: each tenant's query forced alone first (the
   serial results and launches); (a) ``dashboard`` (weight 2, phase 3b's
   chain over its file), ``etl`` (phase 2's ``z = x + x`` by 100,000 keys)
   and ``adhoc`` (phase 3c's Q2.1, and the etl program once as a fresh
   lambda), 4 queries each from three threads into three workers: every
   result bit-equal to its serial forcing, the launches equal to the
   serial count, a cross-tenant interner hit, the pick order and
   dashboard's share while all queues were non-empty; (f) SLOs over (a)'s
   completions, good and bad equal to the futures' walls, etl's burn over
   1 and its callback fired once; (b) ``QueueFull``, ``OverQuota``, a
   cancel of a queued and of a running query, and a permanently failing
   program quarantined after 3 submissions and lifted; (c) priority
   preemption with one worker: a 20M etl query in 80 blocks parks for a
   weight-4 dashboard and resumes, bit-equal to its run alone with the
   same launches; (d) admission under ``TFT_SERVE_HBM_LIMIT_BYTES``: an
   arrival that does not fit beside a running whale (8M x 64 f32 rows)
   makes it park, and one larger than the limit is shed within
   ``TFT_SERVE_ADMISSION_WAIT_S=1``; (e) the regression drill: 6 warm
   dashboard queries, then one with ``TFT_FAULTS=perf:1`` sized from the
   warm median, flagging exactly one ``perf.regression`` on
   ``stage_wall_s``, with baselines persisted under ``build/``; (h)
   ``last_query_report()`` and ``health()``; (g) a child interpreter
   that loads (e)'s baseline, serves 3 queries through ``ttf.submit``
   and SIGKILLs itself while a 4th runs, after which this process reads
   its 3 records back, names its pid as an unclean shutdown and renders
   ``why`` from the archive (its launches join the ``kernels`` line);
   (i) the card's busy share of one served dashboard query under
   ``tracing.profile``;
3m. the serving fabric (``fabric_three_workers_20M``,
   :func:`phase_fabric_three_workers`): phase 3l's three tenants at full
   size through a three-worker ``serve.ServeFabric`` with
   ``TFT_PERSIST_DIR`` under ``build/``: (a) 4 queries a tenant (and the
   etl program once from adhoc), one tenant a worker, every result
   bit-equal to 3l's serial forcing, the launches equal to the serial
   count, the programs interned once for the three workers; (b) the
   worker serving the 80-block etl lost mid-query through the ``worker``
   fault site: the query resumed on a survivor from its persisted
   checkpoint under its id, only the blocks the dead worker never
   finished dispatched, bit-equal, ``why`` one chain across two workers,
   the queries queued behind it re-placed, the card's bytes in use back
   at their value before the fabric; (c) a rolling restart of all three
   workers with a query a tenant in flight: none lost, every restarted
   worker's admission probe passed on the card, a repeated dashboard
   chain (pure programs) answered warm from the durable tier with no
   dispatch; (d) the port's chaos drill (``tools.chaos_soak``) at seed
   11, rate 0.3 over its default ``device|worker|preempt|disk``, two
   rounds, each of which runs the fused distributed plan over 8 shards of
   the card (a shard lost under the device site, re-admitted after the
   round), every site firing: bit-equal to the fault-free run, every
   failure classified, no invariant violation, the same firings
   replayed, the card's bytes back; (e)
   ``TFT_FABRIC=0``: one query bit-equal to a plain scheduler's;
4. the transformer LM at the JAX package's default width (vocab 32,000,
   d_model 512, 8 heads, 6 layers, d_ff 2,048, f32), weights from a numpy
   seed carried in through ``params_from_jax``: ``apply`` and ``loss`` over
   [8, 2048] tokens, 6 flash-attention launches per forward, one sequence
   held against the same model on the CPU with the plain attention;
5. ``generate_via_frame`` over 16 prompts of 128 tokens in 2 partitions,
   16 new tokens, greedy: bit-equal to ``generate`` on the same prompts; a
   sampled run reproduces itself;
5b. training at the same width (``transformer_train_8x2048``,
   :func:`phase_transformer_train`): ``make_sharded_train_step(
   learning_rate=1e-3)`` (adam) over the same [8, 2048] tokens, step 0's
   gradients within 1e-4 of each parameter's max-abs of the plain
   attention's, 5 timed steps each launching the flash forward and its
   backward kernels 6 times, the loss falling, one step profiled, and a
   checkpoint saved under ``build/`` and restored into a fresh state whose
   next step equals the uninterrupted run's bit for bit;
5c. the ported ``train_lm`` demo (``train_lm_demo``): 30 steps with a
   checkpoint every 10, a "crash", a resume to 40, the loss at step 40
   under a tenth of step 1's;
5d. BASELINE config 4 (``resnet50_infer_b32``): ResNet-50 over 256 seeded
   224 x 224 x 3 f32 images in 8 partitions of 32 through
   ``infer_via_frame``, logits [256, 1000], image 0 against the same
   weights on the CPU;
5e. BASELINE config 5 (``logreg_262kx64``): logistic regression over
   262,144 x 64 f32 features in 8 partitions, ``gradient_via_frame``
   against numpy f64 to rtol 1e-5, then 10 steps of ``fit_via_frame``, the
   loss falling;
5f. the transformer on meshes of logical shards of the card
   (``transformer_mesh_8x2048``, :func:`phase_transformer_mesh`), at 4's
   width over [8, 2048] tokens: (a) ``ring_attention`` on 4 seq shards
   against B2 (causal) and the plain attention, ``ring_allreduce`` of
   [8, 1,048,576] f32 on 8, their trace events; (b)
   ``make_sharded_train_step`` on (data 8), (data 2, model 4) and (data 2,
   model 2, seq 2), step 0's loss and gathered gradients against the
   one-device step's, 3 timed steps, B2 and its backward once per layer
   and (data, model) shard a step (none with the ring); (c) 8 experts on
   (data 2, model 2, expert 2) against the one-device step, the dropped
   tokens equal, at capacity factor 0.5 too; (d) the GPipe step on (data
   2, pipe 3), 4 microbatches; (e) 5e's logistic regression on (data 8)
   equal to the one-device step; (f) the ``train_lm`` demo on (data 2,
   model 4), resumed from its checkpoint equal to the uninterrupted run;
6. each kernel against its plain PyTorch version on the card: segment_sum
   over dtypes, segment counts, widths, dropped ids, a hot segment with 90%
   of the rows and a single segment (also at the main path's 250k x 64
   block), 4 sort passes, an empty input and a ragged tail;
   flash_attention over f32/bf16/f16, causal or not, sequence lengths,
   Sq != Sk and head dims; its backward (dq, dk, dv and the forward's
   log-sum-exp) over the same types, lengths 1 to 2,048 and head dims 32,
   64, 128 and 40; each case twice for bit-identity. Then, at the main
   paths' shapes (B2 and its backward also at 5f's per-shard shapes),
   each kernel held against the plain version and itself again and timed
   beside the plain version, one library call and its bound.

Each phase prints one JSON line. Then come a ``{"kernels": [...]}`` line
with each kernel's launches during its main path (phases 1-3m, 2b-2f
included, for segment_sum, the child processes of phases 3h and 3l and
the rank processes of phase 2f included, phases 4-5f
for flash_attention, 5b-5f for its backward; 5f's launches that only
served as the ring's reference left out), the card's name and power
limit from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``. Any
failed check raises: the script then exits non-zero and prints no ``ok``.
It refuses to run without CUDA. Data is random from fixed seeds.

    python3 chip_smoke.py --timings ROOT

times only the kernels (phase 6's timings) of the port checked out at
``ROOT``, an earlier commit unpacked with ``git archive`` say, with this
script's timing code. To compare two designs of a kernel, run it on both
checkouts on one card, alternating (old, new, new, old).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory bandwidth (NVIDIA data sheet)
# H100 SXM dense tensor-core peaks (NVIDIA data sheet): 989 TFLOP/s bf16 and
# f16, 495 TF32. An f32-accurate product on the tensor cores takes three
# TF32 products (3xTF32: hi.hi + hi.lo + lo.hi), so an f32 operation counts
# as three TF32 ones.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after the L2 cache is flushed by a write of ``flush``."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_readme(ttf, np) -> dict:
    df = ttf.frame({"x": np.arange(10.0)})
    out = ttf.map_blocks(lambda x: {"z": x + 3.0}, df)
    rows = out.collect()
    assert out.columns == ["x", "z"], out.columns
    assert [r["z"] for r in rows] == [i + 3.0 for i in range(10)], rows
    assert out.schema["z"].dtype.name == "double"
    return {"rows": len(rows)}


def phase_reference_workload(ttf, np, torch, n=20_000_000, parts=8,
                             keys=100_000) -> dict:
    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)  # positive: the rtol bound is met without cancellation
    df = ttf.frame({"key": key, "x": x}, num_partitions=parts)
    t0 = time.perf_counter()
    zf = ttf.map_blocks(lambda x: {"z": x + x}, df).cache()
    t_map = time.perf_counter() - t0
    z = np.concatenate([b.columns["z"] for b in zf.blocks()])
    assert np.array_equal(z, 2 * x), "map_blocks z = x + x is not exact"
    assert [b.num_rows for b in zf.blocks()] == \
        [b.num_rows for b in df.blocks()]

    t0 = time.perf_counter()
    total = ttf.reduce_blocks(lambda z_input: {"z": torch.sum(z_input)},
                              zf.select(["z"]))
    t_reduce = time.perf_counter() - t0
    want_total = float(np.sum(2 * x))
    np.testing.assert_allclose(total, want_total, rtol=1e-12)

    t0 = time.perf_counter()
    agg = ttf.aggregate({"z": "sum"}, zf.select(["key", "z"]).group_by("key"))
    cols = agg.blocks()[0].columns
    t_agg = time.perf_counter() - t0
    want = np.bincount(key, weights=2 * x, minlength=keys)
    np.testing.assert_array_equal(cols["key"], np.arange(keys))
    assert cols["z"].dtype == np.float64
    np.testing.assert_allclose(cols["z"], want, rtol=1e-12)
    return {"rows": n, "partitions": parts, "keys": keys,
            "map_blocks_wall_s": t_map, "reduce_blocks_wall_s": t_reduce,
            "aggregate_wall_s": t_agg, "sum": total,
            "aggregate_max_rel_err": float(np.max(
                np.abs(cols["z"] - want) / np.abs(want)))}


def phase_kmeans(ttf, np, n=2_000_000, d=64, parts=8, keys=1024) -> dict:
    rng = np.random.default_rng(3)
    key = rng.integers(0, keys, n)
    f = rng.random((n, d), dtype=np.float32)
    df = ttf.frame({"key": key, "f": f}, num_partitions=parts)
    t0 = time.perf_counter()
    agg = ttf.aggregate({"f": "sum"}, df.group_by("key"))
    cols = agg.blocks()[0].columns
    t_agg = time.perf_counter() - t0
    want = np.stack([np.bincount(key, weights=f[:, c], minlength=keys)
                     for c in range(d)], axis=1)
    np.testing.assert_array_equal(cols["key"], np.arange(keys))
    assert cols["f"].dtype == np.float32 and cols["f"].shape == (keys, d)
    np.testing.assert_allclose(cols["f"], want, rtol=1e-5)
    return {"rows": n, "width": d, "partitions": parts, "keys": keys,
            "aggregate_wall_s": t_agg,
            "max_rel_err": float(np.max(np.abs(cols["f"] - want) / want))}


# ---------------------------------------------------------------------------
# phases 2b-2c: the host runtime and the mesh
# ---------------------------------------------------------------------------

def native_both_ways(np, native, fn):
    """``fn()`` with the host runtime and under ``TFT_DISABLE_NATIVE=1``
    (numpy), in turns (library, numpy, numpy, library): ``(library
    result, numpy result, library walls, numpy walls)``; each side's two
    results are bit-equal."""
    out = {False: [], True: []}
    walls = {False: [], True: []}
    for disabled in (False, True, True, False):
        knobs = {"TFT_DISABLE_NATIVE": "1"} if disabled else {}
        with env_scope(**knobs):
            native._load_attempted, native._lib = False, None
            assert native.available() != disabled
            t0 = time.perf_counter()
            out[disabled].append(fn())
            walls[disabled].append(time.perf_counter() - t0)
    native._load_attempted, native._lib = False, None
    for side in out.values():
        assert np.array_equal(side[0], side[1])
    return out[False][0], out[True][0], walls[False], walls[True]


def phase_native_host(ttf, np, torch, n=20_000_000, parts=8,
                      keys=100_000, cells=100_000) -> dict:
    """The host runtime (``native.py`` over ``csrc/host_runtime.cpp``, built
    by ``g++`` at first use) at the reference workload's size, each
    function with the library and with numpy, bit-equal (phase 2b)."""
    from tensorframes_tpu_torch import native
    from tensorframes_tpu_torch.ops import _build

    native._load_attempted, native._lib = False, None
    t0 = time.perf_counter()
    assert native.available(), "the host runtime did not build or load"
    out = {"rows": n, "build_s": time.perf_counter() - t0,
           "library": os.path.basename(_build._library_path("host_runtime")),
           "version": native.lib_version()}
    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    perm = rng.permutation(n)
    lens = rng.integers(1, n // cells, cells)
    ragged = np.split(x[:int(lens.sum())], np.cumsum(lens)[:-1])
    jobs = {
        "convert_f64_to_f32": lambda: native.convert(x, np.float32),
        "convert_i64_to_i32": lambda: native.convert(key, np.int32),
        "gather_rows_f64": lambda: native.gather_rows(x, perm),
        "pad_ragged_f64": lambda: native.pad_ragged(
            ragged, max_len=int(lens.max()))[0],
    }
    for name, fn in jobs.items():
        lib, ref, t_lib, t_np = native_both_ways(np, native, fn)
        assert lib.dtype == ref.dtype and np.array_equal(lib, ref), name
        out[name] = {"native_walls_s": t_lib, "numpy_walls_s": t_np,
                     "bytes": int(lib.nbytes)}
    frame = ttf.frame([(c,) for c in ragged[:cells // 10]], columns=["v"],
                      num_partitions=parts)
    lib, ref, t_lib, t_np = native_both_ways(np, native, lambda: np.concatenate(
        [b.columns["v"] for b in frame.pad_column("v").blocks()]))
    assert np.array_equal(lib, ref), "pad_column"
    out["pad_column_10k_cells"] = {"native_walls_s": t_lib,
                                   "numpy_walls_s": t_np}

    # phase 2's keyed aggregate in its computation form, which gathers each
    # block by key through gather_rows (the monoid form calls no native
    # function: the port's device dtype is the storage dtype)
    small = ttf.frame({"key": key[:2_000_000], "z": 2 * x[:2_000_000]},
                      num_partitions=parts).group_by("key")
    lib, ref, t_lib, t_np = native_both_ways(np, native, lambda: ttf.aggregate(
        lambda z_input: {"z": z_input.sum(0)}, small).blocks()[0]
        .columns["z"])
    assert np.array_equal(lib, ref), "the fold differs without the library"
    np.testing.assert_allclose(lib, np.bincount(
        key[:2_000_000], weights=2 * x[:2_000_000])[np.unique(
            key[:2_000_000])], rtol=1e-12)
    out["aggregate_fold_2M"] = {"native_walls_s": t_lib,
                                "numpy_walls_s": t_np}
    return out


def mesh_route(np, segment_reduce, run, expect_launches: int) -> tuple:
    """One mesh aggregate route run twice: its result (bit-identical across
    the runs), each run's wall and B1 launches (``expect_launches``)."""
    results, walls = [], []
    for _ in range(2):
        l0 = segment_reduce.launches
        t0 = time.perf_counter()
        cols = run().blocks()[0].columns
        walls.append(time.perf_counter() - t0)
        got = segment_reduce.launches - l0
        assert got == expect_launches, (got, expect_launches)
        results.append(cols)
    for k in results[0]:
        assert np.array_equal(results[0][k], results[1][k]), \
            f"{k} differs between two runs"
    return results[0], walls


def phase_mesh_reference_workload(ttf, np, torch, segment_reduce,
                                  n=20_000_000, keys=100_000, parts=8,
                                  shards=8, hot_rows=4_000_000,
                                  max_groups=131_072, device="cuda") -> dict:
    """The reference workload through the parallel layer (phase 2c) on
    ``local_mesh()`` and on a mesh of ``shards`` logical shards of the one
    card: ``distribute`` -> ``dmap_blocks(z = x + x)`` -> ``dfilter(x <
    0.75)`` -> ``dreduce_blocks`` sum and min (collective) and min
    (generic) -> ``daggregate({"z": "sum"})`` by ``key`` with host keys and
    with device keys; a two-key device-key aggregate, a frame where key 0
    holds 80% of the rows (salted on more than one shard) and a generic
    ``daggregate``; every result against numpy, each route bit-identical
    across two runs, B1 launched once per shard and sum column."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.utils import tracing

    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    keep = x < 0.75
    zk, kk = 2 * x[keep], key[keep]
    want = np.bincount(kk, weights=zk, minlength=keys)
    present = np.flatnonzero(np.bincount(kk, minlength=keys))
    k1, k2 = key % 200, key // 1000
    pair = k1 * 100 + k2  # the groups in (k1, k2) order
    pairs = np.unique(pair)
    want_pair = np.bincount(pair, weights=2 * x, minlength=200 * 100)[pairs]
    hot_key = np.where(np.arange(hot_rows) % 5 == 0, key[:hot_rows], 0)
    want_hot = np.bincount(hot_key, weights=2 * x[:hot_rows],
                           minlength=keys)
    hot_present = np.flatnonzero(np.bincount(hot_key, minlength=keys))
    df = ttf.frame({"key": key, "x": x}, num_partitions=parts)
    hot_df = ttf.frame({"key": hot_key, "z": 2 * x[:hot_rows]},
                       num_partitions=parts)
    pair_df = ttf.frame({"k1": k1, "k2": k2, "z": 2 * x},
                        num_partitions=parts)
    dev = torch.device(device)
    meshes = {"local_mesh": parallel.local_mesh(),
              f"{shards}_shards_of_one_card": parallel.DeviceMesh(
                  np.array([dev] * shards, dtype=object))}
    out = {"rows": n, "keys": keys, "kept_rows": int(keep.sum()),
           "max_groups": max_groups}
    for name, mesh in meshes.items():
        S = mesh.num_data_shards
        res = {"shards": S}
        tracing.timings.reset()
        t0 = time.perf_counter()
        dist = parallel.distribute(df, mesh)
        torch.cuda.synchronize()
        res["distribute_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        z = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
        flt = parallel.dfilter(lambda x: x < 0.75, z)
        assert flt.count() == int(keep.sum())
        sel = flt.select(["z"])
        total = parallel.dreduce_blocks({"z": "sum"}, sel)["z"]
        low = parallel.dreduce_blocks({"z": "min"}, sel)["z"]
        low_gen = parallel.dreduce_blocks(
            lambda z_input: {"z": torch.amin(z_input, 0)}, sel)["z"]
        res["map_filter_reduce_s"] = time.perf_counter() - t0
        np.testing.assert_allclose(float(total), zk.sum(), rtol=1e-12)
        assert float(low) == float(low_gen) == zk.min(), (low, low_gen)
        agg = flt.select(["key", "z"])
        routes = {
            "host_keys": (lambda: parallel.daggregate({"z": "sum"}, agg,
                                                      "key"), S),
            "device_keys": (lambda: parallel.daggregate(
                {"z": "sum"}, agg, "key", max_groups=max_groups), S),
            "generic": (lambda: parallel.daggregate(
                lambda z_input: {"z": z_input.sum(0)}, agg, "key"), 0),
        }
        got = {}
        for route, (run, launches) in routes.items():
            cols, walls = mesh_route(np, segment_reduce, run, launches)
            np.testing.assert_array_equal(cols["key"], present)
            np.testing.assert_allclose(cols["z"], want[present], rtol=1e-12)
            got[route] = cols["z"]
            res[route] = {"walls_s": walls, "launches_per_run": launches}
        assert np.array_equal(got["device_keys"], got["host_keys"]), \
            "device keys and host keys give different sums"
        spans = tracing.timings.snapshot()
        fact = spans.get("aggregate.factorize_keys", {}).get("total_s", 0.0)
        ids = spans.get("daggregate.device_key_ids", {}).get("total_s", 0.0)
        res["factorize_keys_s"] = fact
        res["device_key_ids_s"] = ids
        res["factorize_share_of_host_route_first_run"] = (
            fact / res["host_keys"]["walls_s"][0])
        res["id_build_share_of_device_route_first_run"] = (
            ids / res["device_keys"]["walls_s"][0])

        pdist = parallel.distribute(pair_df, mesh)
        cols, walls = mesh_route(np, segment_reduce, lambda: parallel
                                 .daggregate({"z": "sum"}, pdist,
                                             ["k1", "k2"], max_groups=32_768),
                                 S)
        np.testing.assert_array_equal(cols["k1"] * 100 + cols["k2"], pairs)
        np.testing.assert_allclose(cols["z"], want_pair, rtol=1e-12)
        res["two_keys_device"] = {"groups": int(pairs.size),
                                  "walls_s": walls}

        hdist = parallel.distribute(hot_df, mesh)
        frame_holder = {}

        def hot():
            frame_holder["out"] = parallel.daggregate({"z": "sum"}, hdist,
                                                      "key")
            return frame_holder["out"]

        cols, walls = mesh_route(np, segment_reduce, hot, S)
        np.testing.assert_array_equal(cols["key"], hot_present)
        np.testing.assert_allclose(cols["z"], want_hot[hot_present],
                                   rtol=1e-12)
        hot_keys = frame_holder["out"].hot_keys()
        frac = np.count_nonzero(hot_key == 0) / hot_rows
        assert hot_keys == ([{"keys": {"key": 0}, "fraction": frac,
                              "salt_slots": S}] if S > 1 else []), hot_keys
        res["hot_key_80pct"] = {"rows": hot_rows, "walls_s": walls,
                                "hot_keys": hot_keys}
        out[name] = res
        del dist, z, flt, sel, agg, pdist, hdist
    return out


def valid_col(np, frame, name):
    """A distributed frame's valid rows of one column, in global order."""
    a = np.asarray(frame.host_read_padded(name))
    return a[frame.valid_row_mask()]


# synthetic per-shard times for part (c) of phase 2e, cumulative as the
# d-ops record them: shard 7 adds ten times any other shard's time
SKEWED_TIMES = [0.001 * (i + 1) for i in range(7)] + [0.017]


def phase_elastic(ttf, np, torch, segment_reduce, n=20_000_000,
                  keys=100_000, parts=8, shards=8, max_groups=131_072,
                  lost=2, idle_reps=3, stream_rows=2_000_000,
                  stream_batch=200_000, stream_keys=1_000,
                  device="cuda") -> dict:
    """The elastic mesh and the fused distributed plan (phase 2e,
    ``elastic_20M``) on phase 2's 20M rows (``key`` in [0, ``keys``),
    ``x`` uniform, an int64 ``c``) over ``shards`` logical shards of the
    card:

    (a) device loss: each op run healthy, then again with
        ``faults.inject("device", 1)`` naming device ``lost``: dmap_blocks
        (``z = x + x``), dfilter (``x < 0.75``), dreduce_blocks sum and
        min, daggregate ``{"z": "sum", "c": "sum"}`` by ``key`` with host
        and device keys (``max_groups``) and dsort by ``key``; each
        finishes on ``shards - 1`` shards of the card, maps, filters,
        sorts, min and integer sums bit-equal to the healthy run, f64 sums
        within rtol 1e-12 of numpy, ``mesh.reshard_rows`` equal to the
        lost shard's valid rows, B1 once per surviving shard and float
        sum column; both walls printed;
    (b) growth: ``admit_devices`` takes the lost shard back from the lost
        pool; a second frame on the shrunken mesh migrates at its next
        dispatch (``mesh.grow_migrations`` 1), its map bit-identical;
    (c) rebalance: :data:`SKEWED_TIMES` fed through ``note_dispatch``
        ``TFT_SKEW_REBALANCE_AFTER`` times; the next map repartitions in
        proportion (its per-shard valid rows printed), bit-identical, and
        a device-key daggregate over the unequal shards launches B1 on
        each;
    (d) the idle layer's cost: the healthy ``dmap -> daggregate`` chain
        (device keys, so that no host factorization hides the layer)
        with the layer on and under ``elastic.bypass()``, alternating,
        ``idle_reps`` each, walls printed (not gated);
    (e) the fused plan: ``dmap -> dfilter -> dmap -> dreduce`` and ``dmap
        -> daggregate``, eager and through ``lazy()``: integers bit-equal,
        f64 within rtol 1e-12, 4 dispatches against 1 and 2 against 1,
        interstage host bytes > 0 against 0, no fallback, B1 once per
        shard in the fused aggregate, a device loss mid-stage recovered;
    (f) a windowed stream of integer-valued f64 sums (``stream_rows``
        events, exact in f64) on the mesh equal to the one-device run,
        one mesh dispatch and ``shards`` B1 launches per fold.

    The path is traced, so the card's own shard times feed the skew
    tracker throughout: ``mesh.rebalances`` moves once in the phase, at
    part (c), and nowhere else."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.parallel import elastic
    from tensorframes_tpu_torch.resilience import faults
    from tensorframes_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    c = rng.integers(-1000, 1000, n)
    z = x + x
    keep = x < 0.75
    want_z = np.bincount(key, weights=z, minlength=keys)
    want_c = np.bincount(key, weights=c, minlength=keys).astype(np.int64)
    present = np.flatnonzero(np.bincount(key, minlength=keys))
    df = ttf.frame({"key": key, "x": x, "c": c}, num_partitions=parts)
    dev = torch.device(device)
    mesh = parallel.DeviceMesh(np.array([dev] * shards, dtype=object))
    message = f"DEVICE_LOST: injected fault: device {lost} is lost"
    out = {"rows": n, "shards": shards, "lost_device": lost}

    def lose(fn):
        """``fn()`` with the device site armed once; its wall, the rows
        re-sharded and the B1 launches it made."""
        r0 = counters.get("mesh.reshard_rows")
        l0 = segment_reduce.launches
        with faults.inject("device", 1, message=message):
            res, wall = timed(torch, fn)
        return (res, wall, counters.get("mesh.reshard_rows") - r0,
                segment_reduce.launches - l0)

    def check_aggregate(frame, what):
        cols = host_cols(np, frame)
        np.testing.assert_array_equal(cols["key"], present)
        np.testing.assert_array_equal(cols["c"], want_c[present])
        np.testing.assert_allclose(cols["z"], want_z[present], rtol=1e-12)
        return cols

    rb_start = counters.get("mesh.rebalances")
    dist, out["distribute_s"] = timed(
        torch, lambda: parallel.distribute(df, mesh))
    lost_rows = int(dist.per_shard_valid()[lost])
    zdist = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
    ops = {
        "dmap_blocks": lambda d: parallel.dmap_blocks(
            lambda x: {"z": x + x}, d),
        "dfilter": lambda d: parallel.dfilter(lambda x: x < 0.75, d),
        "dreduce_sum": lambda d: parallel.dreduce_blocks(
            {"z": "sum", "c": "sum"}, d.select(["z", "c"])),
        "dreduce_min": lambda d: parallel.dreduce_blocks(
            {"z": "min"}, d.select(["z"])),
        "daggregate_host_keys": lambda d: parallel.daggregate(
            {"z": "sum", "c": "sum"}, d.select(["key", "z", "c"]),
            "key"),
        "daggregate_device_keys": lambda d: parallel.daggregate(
            {"z": "sum", "c": "sum"}, d.select(["key", "z", "c"]),
            "key", max_groups=max_groups),
        "dsort": lambda d: parallel.dsort("key", d),
    }
    loss = {}
    for name, op in ops.items():
        src = dist if name in ("dmap_blocks", "dfilter", "dsort") \
            else zdist
        healthy, healthy_s = timed(torch, lambda: op(src))
        got, lost_s, moved, launches = lose(lambda: op(src))
        rec = {"healthy_s": healthy_s, "recovery_s": lost_s,
               "reshard_rows": moved, "launches": launches}
        assert moved == lost_rows, (name, moved, lost_rows)
        if name in ("dmap_blocks", "dfilter", "dsort"):
            assert got.mesh.num_data_shards == shards - 1, name
            assert all(d.type == dev.type
                       for d in got.mesh.shard_devices()), name
            cols = ("z",) if name == "dmap_blocks" else \
                ("key", "x", "c")
            for cname in cols:
                a = valid_col(np, got, cname)
                assert np.array_equal(a, valid_col(np, healthy, cname)), \
                    (name, cname)
            if name == "dfilter":
                assert got.count() == int(keep.sum())
                np.testing.assert_array_equal(valid_col(np, got, "x"),
                                              x[keep])
            if name == "dsort":
                order = np.argsort(key, kind="stable")
                np.testing.assert_array_equal(valid_col(np, got, "key"),
                                              key[order])
                np.testing.assert_array_equal(valid_col(np, got, "x"),
                                              x[order])
            rec["per_shard_valid"] = [int(v) for v in
                                      got.per_shard_valid()]
        elif name == "dreduce_sum":
            assert int(got["c"]) == int(healthy["c"]) == int(c.sum())
            np.testing.assert_allclose(float(got["z"]), z.sum(),
                                       rtol=1e-12)
        elif name == "dreduce_min":
            assert float(got["z"]) == float(healthy["z"]) == z.min()
        else:
            g = check_aggregate(got, name)
            h = check_aggregate(healthy, name)
            np.testing.assert_array_equal(g["c"], h["c"])
            # B1 once per surviving shard for the one float sum column
            assert launches == shards - 1, (name, launches)
        loss[name] = rec
    assert counters.get("mesh.devices_lost") >= len(ops)
    out["device_loss"] = loss

    # (b) growth: the lost shard comes back from the lost pool
    with faults.inject("device", 1, message=message):
        a = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
    small = a.mesh
    assert small.num_data_shards == shards - 1
    assert elastic.lost_pool() == [lost]
    b = parallel.distribute(df, small)
    m0 = counters.get("mesh.grow_migrations")
    grown, grow_s = timed(torch, lambda: parallel.admit_devices(a))
    assert grown.mesh.num_data_shards == shards
    assert sorted(grown.mesh.flat_ids()) == list(range(shards))
    assert elastic.lost_pool() == []
    bz, pickup_s = timed(torch, lambda: parallel.dmap_blocks(
        lambda x: {"z": x + x}, b))
    assert counters.get("mesh.grow_migrations") - m0 == 1
    assert bz.mesh.num_data_shards == shards
    assert np.array_equal(valid_col(np, bz, "z"), z)
    assert np.array_equal(valid_col(np, grown, "z"), z)
    out["growth"] = {"admit_s": grow_s, "migrated_map_s": pickup_s,
                     "ids": grown.mesh.flat_ids()}
    del a, b, bz, grown

    # (c) rebalance after persistent (synthetic) skew; the healthy and
    # recovering runs before it left the layout alone
    rb0 = counters.get("mesh.rebalances")
    assert rb0 == rb_start, ("rebalanced before (c)", rb0 - rb_start)
    after = int(os.environ.get("TFT_SKEW_REBALANCE_AFTER", "3") or 3)
    for _ in range(after):
        elastic.note_dispatch(mesh, "dmap_blocks", SKEWED_TIMES)
    reb, reb_s = timed(torch, lambda: parallel.dmap_blocks(
        lambda x: {"z": x + x}, dist))
    assert counters.get("mesh.rebalances") - rb0 == 1
    info = reb._rebalance
    valid = [int(v) for v in reb.per_shard_valid()]
    assert valid == info["after"] and sum(valid) == n
    assert valid[-1] == min(valid) < n // shards
    assert np.array_equal(valid_col(np, reb, "z"), z)
    l0 = segment_reduce.launches
    ragg, ragg_s = timed(torch, lambda: parallel.daggregate(
        {"z": "sum", "c": "sum"}, reb.select(["key", "z", "c"]), "key",
        max_groups=max_groups))
    assert segment_reduce.launches - l0 == shards
    check_aggregate(ragg, "rebalanced")
    out["rebalance"] = {"map_s": reb_s, "aggregate_s": ragg_s,
                        "per_shard_valid": valid,
                        "padded_rows_per_shard": reb.padded_rows // shards,
                        "ratio": info["ratio"]}
    del reb, ragg

    # (d) the idle layer's cost on a healthy mesh (printed, not gated)
    def chain():
        zz = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
        return parallel.daggregate({"z": "sum"},
                                   zz.select(["key", "z"]), "key",
                                   max_groups=max_groups)

    walls = {"on": [], "bypass": []}
    for _ in range(idle_reps):
        for mode in ("on", "bypass"):
            ctx = elastic.bypass() if mode == "bypass" \
                else contextlib.nullcontext()
            with ctx:
                _, w = timed(torch, chain)
            walls[mode].append(w)
    out["idle_cost"] = walls

    # (e) the fused plan
    def four(d):
        d = parallel.dmap_blocks(lambda x, c: {"z": x + x,
                                               "ci": c * 3}, d)
        d = parallel.dfilter(lambda x: x < 0.75, d)
        d = parallel.dmap_blocks(lambda z, ci: {"w": z * 2.0,
                                                "wi": ci + 1}, d)
        return parallel.dreduce_blocks({"w": "sum", "wi": "sum"}, d)

    def two(d):
        d = parallel.dmap_blocks(lambda x: {"z": x + x}, d)
        return parallel.daggregate({"z": "sum"},
                                   d.select(["key", "z"]), "key")

    names = ("mesh.dispatches", "mesh.interstage_host_bytes",
             "dplan.fallbacks", "dplan.fused_forcings")
    fused = {}
    want_w = (4.0 * x[keep]).sum()
    want_wi = int((3 * c[keep] + 1).sum())
    for label, chain_fn in (("map_filter_map_reduce", four),
                            ("map_aggregate", two)):
        res = {}
        for mode in ("eager", "lazy", "lazy_again"):
            src = dist if mode == "eager" else dist.lazy()
            l0 = segment_reduce.launches
            (got, wall), cnt = counted(
                counters, names, lambda: timed(torch,
                                               lambda: chain_fn(src)))
            res[mode] = {"wall_s": wall, "counts": cnt,
                         "launches": segment_reduce.launches - l0,
                         "value": got}
        e, f, f2 = res["eager"], res["lazy"], res["lazy_again"]
        for r in (f, f2):
            assert r["counts"]["mesh.dispatches"] == 1, (label, r)
            assert r["counts"]["mesh.interstage_host_bytes"] == 0
            assert r["counts"]["dplan.fallbacks"] == 0
            assert r["counts"]["dplan.fused_forcings"] == 1
        if label == "map_filter_map_reduce":
            assert e["counts"]["mesh.dispatches"] == 4
            assert e["counts"]["mesh.interstage_host_bytes"] > 0
            for r in (e, f, f2):
                assert int(r["value"]["wi"]) == want_wi
                np.testing.assert_allclose(float(r["value"]["w"]),
                                           want_w, rtol=1e-12)
        else:
            assert e["counts"]["mesh.dispatches"] == 2
            assert f["launches"] == f2["launches"] == shards
            ec = host_cols(np, e["value"])
            for r in (f, f2):
                fc = host_cols(np, r["value"])
                np.testing.assert_array_equal(fc["key"], ec["key"])
                np.testing.assert_allclose(fc["z"], want_z[present],
                                           rtol=1e-12)
        fused[label] = {m: {k: v for k, v in r.items() if k != "value"}
                        for m, r in res.items()}
    # a device loss in the middle of the fused stage
    lz = parallel.dfilter(lambda x: x < 0.75, parallel.dmap_blocks(
        lambda x: {"z": x + x}, dist.lazy()))
    r0 = counters.get("mesh.reshard_rows")
    with faults.inject("device", 1, message=message):
        _, loss_s = timed(torch, lz.count)
    assert lz.mesh.num_data_shards == shards - 1
    assert counters.get("mesh.reshard_rows") - r0 == lost_rows
    assert lz.count() == int(keep.sum())
    np.testing.assert_array_equal(valid_col(np, lz, "z"), z[keep])
    fused["device_loss_mid_stage"] = {"wall_s": loss_s}
    out["fused_plan"] = fused
    del lz

    # (f) a windowed stream folding on the mesh
    from tensorframes_tpu_torch import stream

    srng = np.random.default_rng(29)
    skey = srng.integers(0, stream_keys, stream_rows)
    sval = srng.integers(0, 1000, stream_rows).astype(np.float64)
    sts = np.arange(stream_rows, dtype=np.float64) / stream_batch

    def run_stream(m):
        def gen():
            for lo in range(0, stream_rows, stream_batch):
                hi = lo + stream_batch
                yield {"k": skey[lo:hi], "v": sval[lo:hi],
                       "ts": sts[lo:hi]}

        agg = (stream.from_source(stream.GeneratorSource(gen()))
               .group_by("k")
               .aggregate({"v": "sum"}, window=stream.tumbling(3.0),
                          time_col="ts", mesh=m))
        h = agg.start(name=f"elastic-stream-{'mesh' if m else 'one'}")
        h.run()
        return [host_cols(np, f) for f in h.collect_updates()]

    one, one_s = timed(torch, lambda: run_stream(None))
    names = ("stream.mesh_folds", "mesh.dispatches")
    l0 = segment_reduce.launches
    (meshed, mesh_s), cnt = counted(
        counters, names, lambda: timed(torch, lambda: run_stream(mesh)))
    folds = cnt["stream.mesh_folds"]
    launches = segment_reduce.launches - l0
    assert folds > 0 and cnt["mesh.dispatches"] == folds, cnt
    assert launches == shards * folds, (launches, folds)
    assert len(meshed) == len(one)
    for a_, b_ in zip(one, meshed):
        for k in a_:
            np.testing.assert_array_equal(b_[k], a_[k])
    out["stream_mesh"] = {"windows": len(one), "folds": folds,
                          "launches": launches, "one_device_s": one_s,
                          "mesh_s": mesh_s}
    assert counters.get("mesh.rebalances") == rb0 + 1, \
        ("rebalanced after (c)", counters.get("mesh.rebalances") - rb0 - 1)
    del dist, zdist
    return out


# the ten steps of the JAX package's cluster worker (tests/cluster_worker.py),
# run by each rank of phase 2f and of tests/test_torch_cluster.py
CLUSTER_STEPS = ("dmap", "dreduce_monoid", "dreduce_generic",
                 "daggregate_monoid", "daggregate_generic",
                 "daggregate_device_keys", "dfilter", "dsort",
                 "daggregate_composite_keys", "checkpoint_resume")

CLUSTER_RANK = r'''
import hashlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

cfg = json.loads(sys.argv[1])
rank = int(os.environ["TFT_PROCESS_ID"])
world = int(os.environ["TFT_NUM_PROCESSES"])
device = cfg["device"]

import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import parallel as par
from tensorframes_tpu_torch.ops import segment_reduce
from tensorframes_tpu_torch.parallel import cluster
from tensorframes_tpu_torch.resilience import ClusterInitError
from tensorframes_tpu_torch.utils import checkpoint as ckpt
from tensorframes_tpu_torch.utils.tracing import counters

ttf.set_default_device(device)
if device == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
report = {"rank": rank, "world": world}


def done(code):
    print(json.dumps(report), flush=True)
    sys.exit(code)


t0 = time.perf_counter()
try:
    multi = par.initialize(backend=cfg.get("backend"))
except ClusterInitError as e:
    report.update(refused=True, error=str(e),
                  bootstrap_s=time.perf_counter() - t0)
    done(0)
import torch.distributed as tdist

report.update(refused=False, multi=multi, backend=tdist.get_backend(),
              bootstrap_s=time.perf_counter() - t0)
dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
mesh = par.cluster_mesh(local_devices=[dev] * cfg["shards"])
assert mesh.is_cluster and mesh.num_data_shards == cfg["shards"] * world

# the global rows, the same on every rank; each rank distributes its own
rows = cfg["rows"]
n = sum(rows)
lo, hi = sum(rows[:rank]), sum(rows[:rank + 1])
if cfg["data"] == "worker":
    # the JAX worker's rows: rank r's block is arange(rows[r]) + 1000 r
    k = np.concatenate([np.arange(m) % 5 for m in rows]).astype(np.int64)
    x = np.concatenate([np.arange(m, dtype=np.float64) + 1000 * r
                        for r, m in enumerate(rows)])
    ka, kb = k, np.concatenate([np.arange(m) % 3 for m in rows]).astype(
        np.int64)
else:
    # phase 2's reference workload: key in [0, keys), x uniform f64
    rng = np.random.default_rng(cfg["seed"])
    k = rng.integers(0, cfg["keys"], n)
    x = rng.random(n)
    ka, kb = k % 200, k // 1000
v = np.stack([x, -x], 1)
t0 = time.perf_counter()
dist = par.distribute_local({"k": k[lo:hi], "x": x[lo:hi], "v": v[lo:hi]},
                            mesh)
assert dist.num_rows == n, dist.num_rows
report.update(rows_here=hi - lo, shard_valid=dist.shard_valid.tolist(),
              distribute_s=time.perf_counter() - t0)


OP_S = [0.0]


def op(fn):
    """``fn()``, its wall (to a synchronize on the card) added to the
    step's op time: the checks against numpy are not timed."""
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    OP_S[0] += time.perf_counter() - t0
    return out


def cols(frame):
    blocks = frame.blocks()
    return {c: np.concatenate([np.asarray(b.columns[c]) for b in blocks])
            for c in frame.schema.names}


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


REF = {}


def by_key(key, values, reduce):
    """numpy's per-key ``reduce``, keys ascending: sums by ``bincount``,
    other reductions over one stable sort of the keys, kept for ``k``."""
    uk, inv = REF.get(id(key)) or (None, None)
    if uk is None:
        uk, inv = np.unique(key, return_inverse=True)
        if key is k:
            REF[id(key)] = (uk, inv)
    if reduce is np.add:
        if values.ndim == 1:
            return uk, np.bincount(inv, values, minlength=len(uk))
        return uk, np.stack([np.bincount(inv, values[:, c],
                                         minlength=len(uk))
                             for c in range(values.shape[1])], 1)
    order = REF.get(("order", id(key)))
    if order is None:
        order = np.argsort(inv, kind="stable")
        if key is k:
            REF[("order", id(key))] = order
    starts = np.flatnonzero(np.r_[True, np.diff(inv[order]) != 0])
    return uk, reduce.reduceat(values[order], starts)


def close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def check_sums(out, key, vals, rtol=1e-12):
    uk, want = by_key(key, vals, np.add)
    np.testing.assert_array_equal(out["k"], uk)
    close(out["x"], want, rtol)


def step_dmap():
    z = op(lambda: cols(par.dmap_blocks(lambda x: {"z": x * 2.0 + 1.0},
                                        dist).collect_frame()))["z"]
    # collected in global row order: rank 0's rows, then rank 1's
    np.testing.assert_array_equal(z, x * 2.0 + 1.0)
    return digest(z)


def step_dreduce_monoid():
    red = op(lambda: par.dreduce_blocks({"x": "sum", "v": "min"}, dist))
    close(red["x"], x.sum(), 1e-12)
    np.testing.assert_array_equal(red["v"], v.min(0))
    return digest(red["x"], red["v"])


def step_dreduce_generic():
    red = op(lambda: par.dreduce_blocks(
        lambda x_input: {"x": torch.sqrt((x_input ** 2).sum(0))},
        dist.select("x")))
    close(red["x"], np.sqrt((x ** 2).sum()), 1e-9)
    return digest(red["x"])


def step_daggregate_monoid():
    out = op(lambda: cols(par.daggregate({"x": "sum", "v": "max"}, dist,
                                         "k")))
    check_sums(out, k, x)
    np.testing.assert_array_equal(out["v"], by_key(k, v, np.maximum)[1])
    return digest(out["k"], out["x"], out["v"])


def step_daggregate_generic():
    out = op(lambda: cols(par.daggregate(
        lambda x_input: {"x": torch.sqrt((x_input ** 2).sum(0))},
        dist.select(["k", "x"]), "k")))
    uk, sq = by_key(k, x ** 2, np.add)
    np.testing.assert_array_equal(out["k"], uk)
    close(out["x"], np.sqrt(sq), 1e-9)
    return digest(out["k"], out["x"])


def step_daggregate_device_keys():
    out = op(lambda: cols(par.daggregate(
        {"x": "sum"}, dist.select(["k", "x"]), "k",
        max_groups=cfg["max_groups"])))
    check_sums(out, k, x)
    return digest(out["k"], out["x"])


def step_dfilter():
    flt = op(lambda: par.dfilter(lambda x: x < cfg["below"], dist))
    keep = x < cfg["below"]
    assert flt.count() == int(keep.sum()), flt.count()
    red = op(lambda: par.dreduce_blocks({"x": "sum"}, flt.select("x")))
    close(red["x"], x[keep].sum(), 1e-12)
    return digest(flt.shard_valid, red["x"])


def step_dsort():
    flt = par.dfilter(lambda x: x < cfg["below"], dist)
    srt = op(lambda: par.dsort("x", flt.select("x"), descending=True))
    assert srt.shard_valid is None
    got = op(lambda: cols(srt.collect_frame()))["x"]
    np.testing.assert_array_equal(got, np.sort(x[x < cfg["below"]])[::-1])
    return digest(got)


def step_daggregate_composite_keys():
    dist2 = par.distribute_local({"k": ka[lo:hi], "k2": kb[lo:hi],
                                  "x": x[lo:hi]}, mesh)
    out = op(lambda: cols(par.daggregate(
        {"x": "sum"}, dist2, ["k", "k2"],
        max_groups=cfg["composite_groups"])))
    pair = ka * (int(kb.max()) + 1) + kb
    up, want = by_key(pair, x, np.add)
    np.testing.assert_array_equal(out["k"] * (int(kb.max()) + 1)
                                  + out["k2"], up)
    close(out["x"], want, 1e-12)
    return digest(out["k"], out["k2"], out["x"])


def step_checkpoint_resume():
    # each rank writes and reads only its own shards; the restored
    # columns sit on the same slots
    state = {"x": dist.columns["x"], "v": dist.columns["v"]}
    op(lambda: ckpt.save(cfg["ckpt"], state))
    like = {c: a.like([torch.zeros_like(s) for s in a.shards])
            for c, a in state.items()}
    back = op(lambda: ckpt.restore(cfg["ckpt"], like=like))
    for c in state:
        a, b = state[c], back[c]
        assert b.cluster is mesh and b.rows == a.rows
        for so, sn in zip(a.shards, b.shards):
            assert sn.device == so.device
            assert torch.equal(so, sn)
    # the global view of what came back (one allgather a column)
    gx, gv = back["x"].numpy(), back["v"].numpy()
    valid = np.repeat(dist.shard_valid, len(gx) // len(dist.shard_valid))
    mask = np.arange(len(gx)) % (len(gx) // len(dist.shard_valid)) < valid
    np.testing.assert_array_equal(gx[mask], x)
    np.testing.assert_array_equal(gv[mask], v)
    return digest(gx, gv)


def step_dmap_trim():
    # a global program: every process sees the whole padded array
    got = op(lambda: cols(par.dmap_blocks(
        lambda x: {"s": x.sum().reshape(1)}, dist,
        trim=True).collect_frame()))["s"]
    assert got.shape == (1,)
    close(got[0], x.sum(), 1e-12)
    return digest(got)


def step_daggregate_sketch():
    # the sketch route reads the value columns' global host copies
    from tensorframes_tpu_torch import relational as rel

    it = (k * 7) % 13
    d3 = par.distribute_local({"k": k[lo:hi], "x": x[lo:hi],
                               "it": it[lo:hi]}, mesh)
    out = cols(par.daggregate({"x": "sum", "it": rel.approx_distinct(
        bits=10)}, d3, "k"))
    check_sums(out, k, x)
    return digest(*[out[c] for c in sorted(out)])


def step_distribute_global():
    # every process holds the whole frame: distribute places each
    # process's own shards of it
    d = par.distribute(ttf.frame({"k": k, "x": x}), mesh)
    assert d.shard_valid is None and d.num_rows == n
    red = op(lambda: par.dreduce_blocks({"x": "sum"}, d))
    close(red["x"], x.sum(), 1e-12)
    out = op(lambda: cols(par.daggregate({"x": "sum"}, d, "k")))
    check_sums(out, k, x)
    return digest(red["x"], out["k"], out["x"])


def step_cluster_refusals():
    from tensorframes_tpu_torch import relational as rel

    for call in (lambda: par.dexchange("k", dist),
                 lambda: par.shuffle_daggregate({"x": "sum"}, dist, "k"),
                 lambda: par.admit_devices(dist),
                 lambda: rel.sort_merge_join(
                     ttf.frame({"k": k[:4]}), ttf.frame({"k": k[:4]}),
                     on="k", mesh=mesh)):
        try:
            call()
        except NotImplementedError as e:
            assert "cluster mesh" in str(e), e
        else:
            raise AssertionError("a cluster mesh was not refused")
    assert dist.lazy() is dist
    return digest(np.zeros(1))


steps = {name: globals()["step_" + name] for name in cfg["steps"]}
report["steps"] = {}
failed = None
for name, fn in steps.items():
    if failed is not None:
        print(f"[rank {rank}] STEP {name} SKIP", flush=True)
        continue
    b1 = segment_reduce.launches
    host0 = counters.get("mesh.interstage_host_bytes")
    OP_S[0] = 0.0
    t0 = time.perf_counter()
    try:
        d = fn()
        if device == "cuda":
            torch.cuda.synchronize()
    except Exception:
        failed = name
        print(f"[rank {rank}] STEP {name} FAIL", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        continue
    report["steps"][name] = {
        "wall_s": OP_S[0], "step_s": time.perf_counter() - t0, "digest": d,
        "b1_launches": segment_reduce.launches - b1,
        "host_bytes": counters.get("mesh.interstage_host_bytes") - host0}
    print(f"[rank {rank}] STEP {name} OK", flush=True)
report["failed"] = failed
report["b1_launches"] = segment_reduce.launches
if failed is None:
    tdist.barrier()
cluster.shutdown()
done(1 if failed else 0)
'''


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(cfg: dict, world: int = 2, timeout: float = 300.0,
                env: dict = None) -> list:
    """Spawn ``world`` rank processes of :data:`CLUSTER_RANK` from the
    repo's root (each imports only the port, numpy and torch), joined on
    a free local port with ``TFT_REQUIRE_CLUSTER=1``. Each rank's output
    goes to a file of its own (a full pipe would stall a rank inside a
    collective). Past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised. Returns one dict a rank: its exit code,
    output and final JSON report."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = []
    for r in range(world):
        out = tempfile.TemporaryFile(mode="w+")
        child_env = dict(os.environ, TFT_COORDINATOR=f"127.0.0.1:{port}",
                         TFT_NUM_PROCESSES=str(world),
                         TFT_PROCESS_ID=str(r), TFT_REQUIRE_CLUSTER="1",
                         **(env or {}))
        procs.append((subprocess.Popen(
            [sys.executable, "-c", CLUSTER_RANK, json.dumps(cfg)],
            cwd=root, stdout=out, stderr=subprocess.STDOUT, env=child_env,
            text=True), out))
    end = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        for p, _ in procs:
            p.wait()
        raise TimeoutError(
            f"cluster ranks did not finish within {timeout} s: "
            + " | ".join(_read_out(o)[-1500:] for _, o in procs))
    runs = []
    for p, out in procs:
        text = _read_out(out)
        lines = text.strip().splitlines()
        try:
            rep = json.loads(lines[-1]) if lines else None
        except ValueError:
            rep = None
        runs.append({"rc": p.returncode, "out": text, "report": rep})
    return runs


def _read_out(f) -> str:
    f.seek(0)
    text = f.read()
    f.close()
    return text


def demo_kept_rows(np, n: int, seed: int = 0) -> int:
    """The rows ``demos.analytics.make_csv(n=n, seed=seed)`` writes that
    its pipeline's filter keeps (the same generator, drawn the same
    way)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, n)
    rng.integers(0, 8, n)
    rng.normal(10.0, 3.0, n)
    return int((rng.random(n) >= 0.05).sum())


def smi_card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cluster_ranks(runs, backend: str) -> list:
    """Every rank's report after a run of :data:`CLUSTER_RANK`: each rank
    exited 0 with every step passed, on ``backend``; raises otherwise."""
    reps = []
    for r, run in enumerate(runs):
        rep = run["report"]
        assert run["rc"] == 0 and rep is not None \
            and rep.get("failed") is None and not rep.get("refused"), \
            f"rank {r} failed (rc {run['rc']}):\n{run['out'][-4000:]}"
        assert rep["backend"] == backend, (r, rep["backend"], backend)
        reps.append(rep)
    return reps


def phase_cluster(ttf, np, torch, segment_reduce,
                  rows=(11_000_000, 9_000_000), keys=100_000, shards=4,
                  seed=0, csv_rows=2_000_000, one_rank_backend="nccl",
                  device="cuda", timeout=300.0, out=None) -> dict:
    """The multi-process cluster (phase 2f, ``cluster_2x4_20M``): rank
    processes of :data:`CLUSTER_RANK`, each holding ``shards`` logical
    shards of the card, joined through ``TFT_COORDINATOR`` on a free local
    port with ``TFT_REQUIRE_CLUSTER=1`` (a failed bootstrap fails the part)
    and killed, failing the phase, past ``timeout`` seconds. The rows are
    phase 2's (key in [0, ``keys``), x uniform f64), split unevenly,
    ``rows[r]`` to rank r, so the pads sit per process:

    (a) gloo, two ranks sharing the card: the ten steps of the JAX
        package's cluster worker, each checked on both ranks against numpy
        over the global rows (f64 sums to rtol 1e-12), bit-identical
        across the ranks, its wall to a ``cuda.synchronize`` on both; B1
        launched on each rank's shards (``shards`` a float-sum aggregate);
    (b) ``one_rank_backend`` (NCCL) in a one-rank world on the card:
        ``dreduce_blocks`` and ``daggregate`` (device keys) over all the
        rows through the NCCL group, against numpy: the NCCL path's
        plumbing and its collectives on the card (one card: no traffic
        between cards);
    (c) ``backend="nccl"`` with two ranks on the one card: NCCL takes one
        rank per card, so ``initialize`` must raise ``ClusterInitError``
        within the bootstrap deadline naming the shared card (were the
        ranks to join, (a)'s steps would run under it instead);
    (d) the ``analytics`` demo over ``csv_rows`` CSV rows on 8 logical
        shards of the card in this process, against numpy over the file.

    Each part prints a JSON line with the backend, the rows per rank,
    ``shard_valid``, the step walls, the bytes through the host, B1's
    launches and the card's name and power limit. ``out["child_launches"]``
    receives the ranks' B1 launches."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "cluster_ckpt")
    card = smi_card()
    env = {"TFT_BOOTSTRAP_TIMEOUT": "120"}
    base = {"device": device, "shards": shards, "rows": list(rows),
            "data": "reference", "seed": seed, "keys": keys,
            "max_groups": 131_072, "composite_groups": 32_768,
            "below": 0.75, "ckpt": ckpt, "backend": None}
    float_aggs = ("daggregate_monoid", "daggregate_device_keys",
                  "daggregate_composite_keys")
    child = 0

    def part(name, t0, reps, **extra):
        emit({"phase": "cluster_2x4_20M", "part": name,
              "wall_s": time.perf_counter() - t0, "card": card,
              "backend": reps[0]["backend"] if reps else None,
              "rows_per_rank": [r["rows_here"] for r in reps],
              "shard_valid": reps[0]["shard_valid"] if reps else None,
              "bootstrap_s": [r["bootstrap_s"] for r in reps],
              "step_walls": [{s: v["wall_s"] for s, v in r["steps"].items()}
                             for r in reps],
              "step_with_checks_s": [{s: v["step_s"]
                                      for s, v in r["steps"].items()}
                                     for r in reps],
              "host_bytes": [{s: v["host_bytes"]
                              for s, v in r["steps"].items()} for r in reps],
              "b1_launches": [r["b1_launches"] for r in reps], **extra})

    # (a) gloo, two ranks sharing the card
    t0 = time.perf_counter()
    runs = run_cluster(dict(base, steps=list(CLUSTER_STEPS)), world=2,
                       timeout=timeout, env=env)
    shutil.rmtree(ckpt, ignore_errors=True)
    reps = cluster_ranks(runs, "gloo")
    for step in CLUSTER_STEPS:
        got = {r["steps"][step]["digest"] for r in reps}
        assert len(got) == 1, f"{step}: the ranks' results differ"
    for rep in reps:
        assert rep["rows_here"] == rows[rep["rank"]]
        for step in float_aggs:
            assert rep["steps"][step]["b1_launches"] == \
                (shards if device == "cuda" else 0), (step, rep["steps"])
        child += rep["b1_launches"]
    part("a_gloo_two_ranks_one_card", t0, reps)

    # (b) a one-rank world through the NCCL group
    t0 = time.perf_counter()
    runs = run_cluster(dict(base, rows=[sum(rows)],
                            steps=["dreduce_monoid",
                                   "daggregate_device_keys"],
                            backend=one_rank_backend),
                       world=1, timeout=timeout, env=env)
    reps = cluster_ranks(runs, one_rank_backend)
    assert reps[0]["steps"]["daggregate_device_keys"]["b1_launches"] == \
        (shards if device == "cuda" else 0)
    child += reps[0]["b1_launches"]
    part("b_one_rank_world", t0, reps,
         proves="the NCCL backend's bootstrap, its group and its "
                "collectives (allgathers of partials, tables and key "
                "uniques) on the card; one card moves no bytes between "
                "cards, so cross-card traffic is not measured")

    # (c) NCCL asked for two ranks on the one card
    t0 = time.perf_counter()
    runs = run_cluster(dict(base, steps=list(CLUSTER_STEPS),
                            backend="nccl"), world=2, timeout=timeout,
                       env=env)
    shutil.rmtree(ckpt, ignore_errors=True)
    refused = [bool(r["report"] and r["report"].get("refused"))
               for r in runs]
    if all(refused):
        shared = torch.cuda.get_device_name(0) if device == "cuda" \
            else "CPU"
        for run in runs:
            rep = run["report"]
            assert run["rc"] == 0 and shared in rep["error"], rep
            assert rep["bootstrap_s"] < float(env["TFT_BOOTSTRAP_TIMEOUT"])
        outcome = "refused"
        detail = {"error": runs[0]["report"]["error"],
                  "bootstrap_s": [r["report"]["bootstrap_s"]
                                  for r in runs]}
        reps = []
    else:
        reps = cluster_ranks(runs, "nccl")
        for step in CLUSTER_STEPS:
            assert len({r["steps"][step]["digest"] for r in reps}) == 1
        child += sum(r["b1_launches"] for r in reps)
        outcome = "ran"
        detail = {}
    emit({"phase": "cluster_2x4_20M", "part": "c_nccl_two_ranks_one_card",
          "wall_s": time.perf_counter() - t0, "card": card,
          "outcome": outcome, **detail})

    # (d) the analytics demo on 8 logical shards of the card
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.demos import analytics

    t0 = time.perf_counter()
    path = os.path.join(root, "build", "data", "readings.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    analytics.make_csv(path, n=csv_rows, sites=4, sensors=8, seed=0)
    csv_s = time.perf_counter() - t0
    mesh = parallel.DeviceMesh(np.array(
        [torch.device(device, 0) if device == "cuda"
         else torch.device("cpu")] * 8, dtype=object))
    b0 = segment_reduce.launches
    t1 = time.perf_counter()
    ranked = analytics.pipeline(path, mesh=mesh)
    pipeline_s = time.perf_counter() - t1
    launches = segment_reduce.launches - b0
    got = host_cols(np, ranked)
    raw = np.loadtxt(path, delimiter=",", skiprows=1)
    keep = raw[:, 2] >= 0
    assert int(keep.sum()) == demo_kept_rows(np, csv_rows)
    cell = raw[keep, 0].astype(np.int64) * 8 + raw[keep, 1].astype(np.int64)
    want = np.bincount(cell, raw[keep, 2], minlength=32)
    np.testing.assert_allclose(want[got["site"].astype(np.int64) * 8
                                    + got["sensor"]], got["value"],
                               rtol=1e-12, atol=0)
    assert len(got["value"]) == int((np.bincount(cell, minlength=32)
                                     > 0).sum())
    assert (np.diff(got["value"]) <= 0).all(), "not ranked by total"
    assert launches == (8 if device == "cuda" else 0), launches
    os.remove(path)
    emit({"phase": "cluster_2x4_20M", "part": "d_analytics_demo",
          "wall_s": time.perf_counter() - t0, "card": card,
          "csv_rows": csv_rows, "csv_s": csv_s, "pipeline_s": pipeline_s,
          "groups": len(got["value"]), "b1_launches": launches})
    if out is not None:
        out["child_launches"] = child
    return {"ranks": 2, "shards_per_rank": shards, "rows": list(rows),
            "child_launches": child, "c_outcome": outcome}


def host_cols(np, frame) -> dict:
    """A host frame's columns, each concatenated over its blocks."""
    blocks = frame.blocks()
    return {n: np.concatenate([np.asarray(b.columns[n]) for b in blocks])
            for n in frame.schema.names}


def span_total(tracing, name) -> float:
    return tracing.timings.snapshot().get(name, {}).get("total_s", 0.0)


def timed(torch, fn):
    """``fn()`` and its wall in seconds, the card synchronized."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(counters, names, fn):
    """``fn()`` and how much each named counter rose while it ran."""
    before = {k: counters.get(k) for k in names}
    out = fn()
    return out, {k: counters.get(k) - before[k] for k in names}


def phase_shuffle(ttf, np, torch, segment_reduce, n=20_000_000, parts=8,
                  keys=100_000, groups=2_000_000, users=1_000_000,
                  sketch_keys=100, build_rows=4_000_000,
                  probe_rows=6_000_000,
                  shards=8, sort_limit=256 << 20, device="cuda") -> dict:
    """The shuffle (phase 2d, ``shuffle_20M``) at the reference workload's
    size (``PerformanceSuite.scala:14-26``: 20M f64 rows in 8 partitions,
    320 MB of tensor columns) on ``local_mesh()`` and on ``shards`` logical
    shards of the one card:

    (a) ``dsort`` by ``key`` (int64 over ``keys`` values) ascending, then
        by (``key``, ``x``) descending, each order bit-equal to numpy's
        stable lexsort and the two meshes bit-equal;
    (b) (a)'s first sort under a ledger of ``sort_limit`` bytes
        (``memory.configure``): the external sort, a run a quarter of the
        budget, bit-equal to (a);
    (c) ``daggregate({"v": "sum", "c": "max"})`` keyed over ``groups``
        distinct int64 values: on the shards it routes through
        ``shuffle_daggregate``; again under ``TFT_SHUFFLE=0`` (the dense
        route, a ``[groups]`` table on every shard) and on one shard; max
        equal and sums to rtol 1e-12 of numpy's; a ``dexchange`` of 2M of
        the keys, each row on the shard of its host hash; the sketch route,
        ``{"u": approx_distinct(bits=10), "v": "sum"}`` of a user column
        by a ``sketch_keys``-valued key, bit-equal to the one-device
        ``aggregate``;
    (d) ``join(probe, build, mesh=shards)`` of ``probe_rows`` probe rows
        (the first of the ``n``; 6M, SSB SF 1's lineorder, the cut the
        phase's time asks for: PERF.md, shuffle_20M) against ``build_rows`` unique keys with two f64
        columns (96 MB at 4M, over the 64 MiB broadcast limit): routed
        ``partitioned``, bit-identical to ``broadcast_join``, a shard's
        build about 1/``shards`` of the whole; under ``TFT_SHUFFLE=0``
        routed ``sort_merge`` through the mesh ``dsort``, and on one shard
        ``sort_merge`` (the shuffle needs two), both with the same rows in
        (k, row) order; the partitioned result aggregated by ``key``
        through B1, against numpy.

    Returns each part's walls, counters, routes and B1 launches."""
    from tensorframes_tpu_torch import memory, parallel, relational
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    probe_rows = n if probe_rows is None else probe_rows
    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    dev = torch.device(device)
    meshes = {"local_mesh": parallel.local_mesh(),
              f"{shards}_shards_of_one_card": parallel.DeviceMesh(
                  np.array([dev] * shards, dtype=object))}
    multi = f"{shards}_shards_of_one_card"
    out = {"rows": n, "parts": parts, "keys": keys,
           "meshes": {k: m.num_data_shards for k, m in meshes.items()}}

    # -- (a) dsort ------------------------------------------------------------
    df = ttf.frame({"key": key, "x": x}, num_partitions=parts)
    asc = np.argsort(key, kind="stable")
    desc = np.lexsort((-x, ~key))
    want = {"asc": (key[asc], x[asc]), "desc": (key[desc], x[desc])}
    part_a = {}
    sorted_by = {}
    dists = {}
    for name, mesh in meshes.items():
        l0 = segment_reduce.launches
        dist, put_s = timed(torch, lambda: parallel.distribute(df, mesh))
        dists[name] = dist
        res = {"distribute_s": put_s}
        for label, ks, descending in (("asc", "key", False),
                                      ("desc", ["key", "x"], True)):
            span0 = {s: span_total(tracing, s) for s in
                     ("dsort.columnsort_dispatch", "dsort.dispatch")}
            srt, wall = timed(torch, lambda: parallel.dsort(
                ks, dist, descending=descending))
            cols, collect_s = timed(torch, lambda: host_cols(
                np, srt.collect_frame()))
            assert srt.shard_valid is None
            np.testing.assert_array_equal(cols["key"], want[label][0])
            np.testing.assert_array_equal(cols["x"], want[label][1])
            sorted_by[(name, label)] = cols
            res[label] = {"wall_s": wall, "collect_s": collect_s, **{
                s: span_total(tracing, s) - span0[s] for s in span0}}
        res["launches"] = segment_reduce.launches - l0
        part_a[name] = res
    for label in ("asc", "desc"):
        for c in ("key", "x"):
            assert np.array_equal(sorted_by[("local_mesh", label)][c],
                                  sorted_by[(multi, label)][c])
    emit({"phase": "shuffle_20M", "part": "a_dsort", **part_a})
    out["a_dsort"] = part_a

    # -- (b) the external sort ----------------------------------------------
    part_b = {"limit_bytes": sort_limit}
    for name, dist in dists.items():
        memory.configure(limit_bytes=sort_limit)
        try:
            srt, stats = counted(counters, (
                "memory.external_sorts", "memory.external_sort_runs",
                "memory.spills"), lambda: timed(torch, lambda: parallel
                                                .dsort("key", dist)))
        finally:
            memory._reset()
        srt, wall = srt
        cols = host_cols(np, srt.collect_frame())
        for c in ("key", "x"):
            assert np.array_equal(cols[c], sorted_by[(name, "asc")][c]), \
                f"the external sort differs from the in-memory one: {c}"
        assert stats["memory.external_sorts"] == 1, stats
        runs = stats["memory.external_sort_runs"]
        # a run is a quarter of the budget; a row is 16 bytes
        assert runs == -(-n // (sort_limit // 4 // 16)), stats
        part_b[name] = {"wall_s": wall, **stats}
    emit({"phase": "shuffle_20M", "part": "b_external_sort", **part_b})
    out["b_external_sort"] = part_b
    del dists, sorted_by

    # -- (c) high-cardinality and sketch daggregate -------------------------
    g = rng.integers(0, groups, n)
    c_col = rng.integers(-10 ** 9, 10 ** 9, n)
    present = np.flatnonzero(np.bincount(g, minlength=groups))
    want_v = np.bincount(g, weights=x, minlength=groups)[present]
    cmax = torch.full((groups,), np.iinfo(np.int64).min, dtype=torch.int64)
    cmax.scatter_reduce_(0, torch.from_numpy(g), torch.from_numpy(c_col),
                         "amax")
    want_c = cmax.numpy()[present]
    gdf = ttf.frame({"g": g, "v": x, "c": c_col}, num_partitions=parts)
    fetches = {"v": "sum", "c": "max"}
    part_c = {"groups": int(present.size)}
    group_shard = np.bincount(
        (parallel.exchange.exchange_hash_host([present])
         % np.uint64(shards)).astype(np.int64), minlength=shards)
    row_bytes = 8 + 8  # a group's v (f64) and c (int64) state

    def check(frame):
        cols = host_cols(np, frame)
        np.testing.assert_array_equal(cols["g"], present)
        np.testing.assert_array_equal(cols["c"], want_c)
        np.testing.assert_allclose(cols["v"], want_v, rtol=1e-12)
        return cols

    for name, mesh in meshes.items():
        dist = parallel.distribute(gdf, mesh)
        routes = {"dense": "0"} if mesh.num_data_shards == 1 else \
            {"shuffle": "1", "dense": "0"}
        res = {}
        for route, knob in routes.items():
            with env_scope(TFT_SHUFFLE=knob):
                l0 = segment_reduce.launches
                (frame, wall), cnt = counted(counters, (
                    "mesh.shuffle_agg_routes", "mesh.shuffle_daggregates",
                    "mesh.exchange_rows"), lambda: timed(
                        torch, lambda: parallel.daggregate(
                            fetches, dist, "g")))
                check(frame)
            S = mesh.num_data_shards
            if route == "shuffle":
                assert cnt["mesh.shuffle_daggregates"] == 1, cnt
                state = int(group_shard.max()) * row_bytes
            else:
                assert cnt["mesh.shuffle_daggregates"] == 0, cnt
                state = int(present.size) * row_bytes
            res[route] = {"wall_s": wall, "launches":
                          segment_reduce.launches - l0,
                          "state_bytes_per_shard": state,
                          "groups_per_shard": (group_shard.tolist()
                                               if route == "shuffle"
                                               else [int(present.size)] * S),
                          **cnt}
        part_c[name] = res
        del dist
    # the device hash on the card places rows by the host hash
    m = min(n, 2_000_000)
    ex, ex_s = timed(torch, lambda: parallel.dexchange("g", parallel
                                                      .distribute(ttf.frame(
                                                          {"g": g[:m]}),
                                                          meshes[multi])))
    rows_per = ex.padded_rows // shards
    placed = ex.host_read_padded("g")
    dest = (parallel.exchange.exchange_hash_host([g[:m]])
            % np.uint64(shards)).astype(np.int64)
    for s, cnt in enumerate(ex.per_shard_valid()):
        np.testing.assert_array_equal(
            placed[s * rows_per:s * rows_per + int(cnt)], g[:m][dest == s])
    part_c["placement"] = {"rows": m, "dexchange_s": ex_s,
                           "per_shard": ex.per_shard_valid().tolist()}
    del ex, placed
    sk = rng.integers(0, sketch_keys, n)
    u = rng.integers(0, users, n)
    sdf = ttf.frame({"sk": sk, "u": u, "v": x}, num_partitions=parts)
    sfetch = {"u": relational.approx_distinct(bits=10), "v": "sum"}
    l0 = segment_reduce.launches
    host, host_s = timed(torch, lambda: ttf.aggregate(
        sfetch, sdf.group_by("sk")))
    hcols = host_cols(np, host)
    sdist = parallel.distribute(sdf, meshes[multi])
    (mesh_out, mesh_s), cnt = counted(counters, ("relational.sketch_folds",),
                                      lambda: timed(torch, lambda: parallel
                                                    .daggregate(sfetch, sdist,
                                                                "sk")))
    mcols = host_cols(np, mesh_out)
    assert list(mcols) == list(hcols), (list(mcols), list(hcols))
    np.testing.assert_array_equal(mcols["sk"], hcols["sk"])
    np.testing.assert_array_equal(mcols["u"], hcols["u"])  # the registers
    np.testing.assert_allclose(mcols["v"], np.bincount(
        sk, weights=x, minlength=sketch_keys), rtol=1e-12)
    part_c["sketch"] = {"keys": sketch_keys, "users": users,
                        "host_aggregate_s": host_s, "daggregate_s": mesh_s,
                        "launches": segment_reduce.launches - l0, **cnt}
    del sdist
    emit({"phase": "shuffle_20M", "part": "c_daggregate", **part_c})
    out["c_daggregate"] = part_c

    # -- (d) joins -------------------------------------------------------------
    bk = rng.permutation(build_rows).astype(np.int64)
    w1, w2 = rng.random(build_rows), rng.random(build_rows)
    pk = rng.integers(0, 2 * build_rows, probe_rows)
    probe = ttf.frame({"k": pk, "key": key[:probe_rows], "x": x[:probe_rows]},
                      num_partitions=parts)
    build = ttf.frame({"k": bk, "w1": w1, "w2": w2}, num_partitions=parts)
    mesh = meshes[multi]
    part_d = {"probe_rows": probe_rows, "build_rows": build_rows,
              "build_bytes": build_rows * 24,
              "cut": (None if probe_rows == n else
                      f"the probe side cut to {probe_rows} of the {n} rows")}
    l0 = segment_reduce.launches
    part, part_s = timed(torch, lambda: relational.join(
        probe, build, "k", mesh=mesh))
    assert part._join_route["strategy"] == "partitioned", part._join_route
    pcols, force_s = timed(torch, lambda: host_cols(np, part))
    bcast = relational.broadcast_join(probe, build, "k")
    bcols, bcast_s = timed(torch, lambda: host_cols(np, bcast))
    assert [b.num_rows for b in part.blocks()] == \
        [b.num_rows for b in bcast.blocks()]
    for c in bcols:
        assert np.array_equal(pcols[c], bcols[c]), \
            f"partitioned join differs from the broadcast join: {c}"
    info = part._partitioned_info
    assert info["shards"] == shards
    assert info["max_build_bytes"] * shards < 2 * info["global_build_bytes"]
    agg, agg_s = timed(torch, lambda: ttf.aggregate(
        {"w1": "sum"}, ttf.frame({"key": pcols["key"], "w1": pcols["w1"]},
                                 num_partitions=parts).group_by("key")))
    acols = host_cols(np, agg)
    joined_key = pcols["key"]
    np.testing.assert_array_equal(acols["key"], np.unique(joined_key))
    np.testing.assert_allclose(acols["w1"], np.bincount(
        joined_key, weights=pcols["w1"])[acols["key"]], rtol=1e-12)
    with env_scope(TFT_SHUFFLE="0"):
        smj, smj_s = timed(torch, lambda: relational.join(
            probe, build, "k", mesh=mesh))
        assert smj._join_route["strategy"] == "sort_merge", smj._join_route
        scols, smj_force_s = timed(torch, lambda: host_cols(np, smj))
    one, one_s = timed(torch, lambda: relational.join(
        probe, build, "k", mesh=meshes["local_mesh"]))
    assert one._join_route["strategy"] == "sort_merge", one._join_route
    ocols, one_force_s = timed(torch, lambda: host_cols(np, one))
    # the same rows once both are ordered by (k, probe row)
    prow = np.flatnonzero(np.isin(pk, bk))
    order = np.lexsort((prow, pk[prow]))
    for c in ("k", "key", "x", "w1", "w2"):
        assert np.array_equal(scols[c], pcols[c][order]), c
        assert np.array_equal(ocols[c], scols[c]), c
    assert part_c[multi]["shuffle"]["launches"] > 0 and \
        segment_reduce.launches > l0, "parts (c) and (d) launched no B1"
    part_d.update({
        "rows_out": int(len(pcols["k"])),
        "routes": {"partitioned": part._join_route,
                   "sort_merge": smj._join_route,
                   "one_shard": one._join_route},
        "partitioned_s": part_s + force_s, "broadcast_s": bcast_s,
        "sort_merge_s": smj_s + smj_force_s,
        "one_shard_sort_merge_s": one_s + one_force_s, "aggregate_s": agg_s,
        "max_build_bytes": info["max_build_bytes"],
        "global_build_bytes": info["global_build_bytes"],
        "build_share_of_one_shard": (info["max_build_bytes"]
                                     / info["global_build_bytes"]),
        "launches": segment_reduce.launches - l0})
    emit({"phase": "shuffle_20M", "part": "d_joins", **part_d})
    out["d_joins"] = part_d
    return out


def scan_file(np, n, groups, keys, seed) -> tuple:
    """The plan phase's parquet file under ``build/data/`` (gitignored),
    written from ``seed`` unless a file with the same parameters (kept in
    its key-value metadata) is there. Row group ``g`` holds rows
    ``[g * n / groups, (g + 1) * n / groups)``: ``ts`` int64 equal to the
    row index (sorted, so row-group min/max can refute a time range),
    ``key`` int64 uniform in [0, keys), ``x``, ``y``, ``a``, ``b`` f64
    uniform in [0, 1); ``a`` and ``b`` are read by nothing. Returns the
    path and the seconds spent writing (0 when reused)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    params = json.dumps({"rows": n, "groups": groups, "keys": keys,
                         "seed": seed, "layout": 1}, sort_keys=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "data")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"plan_scan_{n}x{groups}_{keys}_{seed}.parquet")
    if os.path.exists(path):
        meta = pq.read_metadata(path).metadata or {}
        if meta.get(b"chip_smoke") == params.encode():
            return path, 0.0
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    per = n // groups
    schema = pa.schema([("ts", pa.int64()), ("key", pa.int64()),
                        ("x", pa.float64()), ("y", pa.float64()),
                        ("a", pa.float64()), ("b", pa.float64())],
                       metadata={"chip_smoke": params})
    tmp = path + ".tmp"
    with pq.ParquetWriter(tmp, schema) as writer:
        for g in range(groups):
            cols = {"ts": np.arange(g * per, (g + 1) * per, dtype=np.int64),
                    "key": rng.integers(0, keys, per)}
            for c in ("x", "y", "a", "b"):
                cols[c] = rng.random(per)
            writer.write_table(pa.table(cols, schema=schema),
                               row_group_size=per)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


# the order of the timed runs after the first (cold) fused one: True is
# fused, False per-op (TFT_FUSE=0); three of each
TIMED_ORDER = (False, True, True, False, False, True)


def phase_plan_parquet(ttf, np, torch, segment_reduce, n=20_000_000,
                       groups=20, keys=100_000, seed=11) -> dict:
    """The lazy query path over a parquet file, fused and under
    ``TFT_FUSE=0`` (see the module docstring, phase 3b)."""
    import pyarrow.parquet as pq

    from tensorframes_tpu_torch.plan.optimize import build_plan
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    path, write_s = scan_file(np, n, groups, keys, seed)
    cut = n // 2  # ts >= cut keeps the second half of the row groups

    # the reference, straight from the file with pyarrow and numpy
    t0 = time.perf_counter()
    tbl = pq.read_table(path, columns=["ts", "key", "x", "y"])
    ts, key = tbl.column("ts").to_numpy(), tbl.column("key").to_numpy()
    kept = ts >= cut
    w = (tbl.column("x").to_numpy()[kept] + tbl.column("y").to_numpy()[kept]) \
        * 2.0
    want = np.bincount(key[kept], weights=w, minlength=keys)
    want_keys = np.flatnonzero(np.bincount(key[kept], minlength=keys))
    del tbl, ts, key, kept, w
    reference_s = time.perf_counter() - t0
    md = pq.read_metadata(path)
    per_group = [{md.row_group(g).column(j).path_in_schema:
                  md.row_group(g).column(j).total_uncompressed_size
                  for j in range(md.num_columns)} for g in range(groups)]
    read_cols = ("ts", "key", "x", "y")
    fused_bytes = sum(per_group[g][c] for g in range(groups // 2, groups)
                      for c in read_cols)
    all_bytes = sum(sum(pg.values()) for pg in per_group)

    def query():
        df = ttf.read_parquet(path)
        with ttf.dsl.with_graph():
            z = (ttf.block(df, "x") + ttf.block(df, "y")).named("z")
        return (df.map_blocks(z)
                  .filter(lambda ts: ts >= cut)
                  .map_rows(lambda z: {"w": z * 2.0})
                  .select(["key", "w"]))

    names = ("plan.fused_queries",
             "io.parquet_row_groups_read", "io.parquet_bytes_read",
             "plan.pushdown_groups_skipped")

    def run(fuse: bool) -> dict:
        prior = os.environ.get("TFT_FUSE")
        os.environ["TFT_FUSE"] = "1" if fuse else "0"
        try:
            c0 = {k: counters.get(k) for k in names}
            s0 = tracing.timings.snapshot()
            l0 = segment_reduce.launches
            t0 = time.perf_counter()
            chain = query()
            plan = build_plan(chain) if fuse else None
            agg = ttf.aggregate({"w": "sum"}, chain.group_by("key"))
            cols = agg.blocks()[0].columns
            wall = time.perf_counter() - t0
        finally:
            if prior is None:
                del os.environ["TFT_FUSE"]
            else:
                os.environ["TFT_FUSE"] = prior
        s1 = tracing.timings.snapshot()
        spans = {k: {"count": v["count"] - s0.get(k, {}).get("count", 0),
                     "total_s": v["total_s"] - s0.get(k, {}).get("total_s",
                                                                   0.0)}
                 for k, v in s1.items()
                 if v["count"] > s0.get(k, {}).get("count", 0)}
        blocks = chain.blocks()  # the forced (cached) chain
        return {"cols": cols, "plan": plan, "chain": chain,
                "nonempty": sum(1 for b in blocks if b.num_rows),
                "blocks": len(blocks), "wall_s": wall,
                "counts": {k: counters.get(k) - c0[k] for k in names},
                "launches": segment_reduce.launches - l0, "spans": spans}

    # the first fused run also pays the one-time import and tracing of
    # the plan's proofs; then per-op and warm fused runs alternate
    # (per-op, fused, fused, per-op, ...) so that neither side always
    # runs later than the other
    fused = run(True)
    timed = {True: [], False: []}
    for fuse in TIMED_ORDER:
        r = run(fuse)
        if timed[fuse]:
            del r["chain"], r["plan"]  # free its forced blocks
        timed[fuse].append(r)
    unfused, again = timed[False][0], timed[True][0]

    def force():
        chain = query()
        return chain.blocks() + ttf.aggregate(
            {"w": "sum"}, chain.group_by("key")).blocks()

    default = default_forcings(np, force)
    fc, uc = fused["counts"], unfused["counts"]
    plan = fused["plan"]
    assert plan is not None and fused["chain"]._plan_info, \
        "the chain did not take the fused path"
    assert unfused["chain"]._plan_info is None
    assert fc["plan.fused_queries"] == 1 and uc["plan.fused_queries"] == 0, \
        (fc, uc)
    assert plan.leaf_required == read_cols, plan.leaf_required
    assert fc["io.parquet_row_groups_read"] == groups // 2, fc
    assert fc["io.parquet_bytes_read"] == fused_bytes, (fc, fused_bytes)
    assert fc["plan.pushdown_groups_skipped"] == groups // 2, fc
    assert uc["io.parquet_row_groups_read"] == groups, uc
    assert uc["io.parquet_bytes_read"] == all_bytes, (uc, all_bytes)
    nonempty = fused["nonempty"]
    assert nonempty == groups // 2 and fused["blocks"] == groups
    spans = fused["spans"]
    stages = len(plan.stages)
    # one host->device conversion per non-empty block; one dispatch per
    # stage and block, where the per-op path dispatches once per op and
    # block
    assert spans["executor.convert"]["count"] == nonempty, spans
    assert spans["executor.dispatch"]["count"] == stages * nonempty, spans
    assert unfused["spans"]["executor.dispatch"]["count"] == \
        2 * groups + nonempty, unfused["spans"]
    for r in (fused, unfused):
        assert r["launches"] > 0, "aggregate never launched segment_sum"
        np.testing.assert_array_equal(r["cols"]["key"], want_keys)
        assert r["cols"]["w"].dtype == np.float64
    np.testing.assert_allclose(fused["cols"]["w"], want[want_keys],
                               rtol=1e-12)
    assert np.array_equal(fused["cols"]["w"], unfused["cols"]["w"]), \
        "fused and TFT_FUSE=0 differ"
    for r in timed[True] + timed[False]:
        assert np.array_equal(fused["cols"]["w"], r["cols"]["w"])
    walls = {fuse: sorted(r["wall_s"] for r in timed[fuse])
             for fuse in timed}
    keep = ("plan.execute", "executor.convert", "executor.dispatch",
            "executor.convert_back", "io.parquet_read",
            "aggregate.factorize_keys", "aggregate.segment_reduce")
    return {"source": "parquet", "rows": n, "row_groups": groups,
            "keys": keys, "kept_rows": n - cut, "file_write_s": write_s,
            "reference_s": reference_s, "stages": stages,
            "plan": fused["chain"]._plan_info,
            "fused_cold_wall_s": fused["wall_s"],
            "default_knobs": default,
            "timed_order": ["fused" if f else "per_op" for f in TIMED_ORDER],
            "fused_walls_s": [r["wall_s"] for r in timed[True]],
            "unfused_walls_s": [r["wall_s"] for r in timed[False]],
            "fused_median_s": walls[True][len(walls[True]) // 2],
            "unfused_median_s": walls[False][len(walls[False]) // 2],
            "read": {"fused": {"row_groups": fc["io.parquet_row_groups_read"],
                               "bytes": fc["io.parquet_bytes_read"],
                               "columns": list(plan.leaf_required)},
                     "unfused": {"row_groups":
                                 uc["io.parquet_row_groups_read"],
                                 "bytes": uc["io.parquet_bytes_read"]}},
            "segment_sum_launches": {"fused": fused["launches"],
                                     "unfused": unfused["launches"]},
            "spans_fused": {k: v for k, v in spans.items() if k in keep},
            "spans_unfused": {k: v for k, v in unfused["spans"].items()
                              if k in keep},
            "spans_fused_again": {k: v for k, v in again["spans"].items()
                                  if k in keep},
            "max_rel_err": float(np.max(np.abs(fused["cols"]["w"]
                                               - want[want_keys])
                                        / np.abs(want[want_keys])))}


# SSB dictionary codes: categories MFGR#11..MFGR#55 are 0..24 (MFGR#12 is
# 1), regions AFRICA, AMERICA, ASIA, EUROPE, MIDDLE EAST are 0..4
MFGR12, AMERICA = 1, 1
SSB_DAYS = 2556


def ssb_tables(np, rows, parts=200_000, suppliers=2_000, customers=30_000,
               seed=21) -> tuple:
    """SSB's tables with the columns Q2.1 reads, from a numpy seed: scale
    factor 1 with the default counts and 6M ``rows``, smaller counts for
    the tests. Dimension keys are dense and carry the fact table's names
    (``join(on=)`` takes one name for both sides). ``p_brand1 // 40 ==
    p_category`` and ``p_mfgr = p_category // 5`` as in SSB; five nations
    a region. Q2.1 reads neither ``d_yearmonthnum``, ``p_mfgr`` nor
    ``s_nation``."""
    rng = np.random.default_rng(seed)
    days = np.datetime64("1992-01-01") + np.arange(SSB_DAYS)
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    datekey = (year * 10000 + month * 100 + day).astype(np.int32)
    date = {"lo_orderdate": datekey, "d_year": year.astype(np.int32),
            "d_yearmonthnum": (year * 100 + month).astype(np.int32)}
    brand = rng.integers(0, 1000, parts).astype(np.int32)
    part = {"lo_partkey": np.arange(1, parts + 1, dtype=np.int32),
            "p_category": brand // 40, "p_brand1": brand,
            "p_mfgr": brand // 200}
    nation = rng.integers(0, 25, suppliers).astype(np.int32)
    supplier = {"lo_suppkey": np.arange(1, suppliers + 1, dtype=np.int32),
                "s_region": nation // 5, "s_nation": nation}
    lineorder = {
        "lo_orderdate": datekey[rng.integers(0, SSB_DAYS, rows)],
        "lo_partkey": rng.integers(1, parts + 1, rows, dtype=np.int32),
        "lo_suppkey": rng.integers(1, suppliers + 1, rows, dtype=np.int32),
        "lo_custkey": rng.integers(1, customers + 1, rows, dtype=np.int32),
        "lo_revenue": rng.integers(90_000, 10_000_000, rows).astype(
            np.float64)}
    return lineorder, date, part, supplier


def ssb_reference(np, tables, q21: bool) -> dict:
    """Q2.1 (or its roll-up without the filter) in numpy: the joins by
    array indexing (dense dimension keys), revenue summed in int64."""
    lineorder, date, part, supplier = tables
    di = np.searchsorted(date["lo_orderdate"], lineorder["lo_orderdate"])
    pi = lineorder["lo_partkey"] - 1
    key = (date["d_year"][di].astype(np.int64) - 1992) * 1000 \
        + part["p_brand1"][pi]
    rev = lineorder["lo_revenue"].astype(np.int64)
    if q21:
        keep = (part["p_category"][pi] == MFGR12) & \
            (supplier["s_region"][lineorder["lo_suppkey"] - 1] == AMERICA)
        key, rev = key[keep], rev[keep]
    acc = np.zeros(7 * 1000, np.int64)
    np.add.at(acc, key, rev)
    groups = np.flatnonzero(np.bincount(key, minlength=7000))
    return {"d_year": (groups // 1000 + 1992).astype(np.int32),
            "p_brand1": (groups % 1000).astype(np.int32),
            "lo_revenue": acc[groups].astype(np.float64)}


def ssb_chain(m, tables, partitions, q21=True, sort_merge=False):
    """Q2.1's joins, filter and select through package ``m`` (the port
    or, in the tests, the JAX package): lineorder joined to date, part
    and supplier; the roll-up without the filter; the part join as the
    host sort-merge join when asked."""
    lineorder, date, part, supplier = tables
    lo = m.frame(dict(lineorder), num_partitions=partitions)
    j = lo.join(m.frame(dict(date)), on="lo_orderdate")
    j = j.join(m.frame(dict(part)), on="lo_partkey",
               strategy="sort_merge" if sort_merge else None)
    j = j.join(m.frame(dict(supplier)), on="lo_suppkey")
    if q21:
        j = j.filter(lambda p_category, s_region:
                     (p_category == MFGR12) & (s_region == AMERICA))
    return j.select(["d_year", "p_brand1", "lo_revenue"])


def ssb_aggregate(m, chain):
    """The revenue by ``(d_year, p_brand1)`` of ``chain``, ordered."""
    agg = m.aggregate({"lo_revenue": "sum"},
                      chain.group_by("d_year", "p_brand1"))
    return agg.order_by("d_year", "p_brand1")


def ssb_query(m, tables, partitions, **kw) -> tuple:
    """``(chain, ordered aggregate)`` of Q2.1 or its roll-up."""
    chain = ssb_chain(m, tables, partitions, **kw)
    return chain, ssb_aggregate(m, chain)


# the order of the timed Q2.1 runs after the first (cold) fused one
SSB_ORDER = (False, True, True, False)


def phase_ssb_q21(ttf, np, torch, segment_reduce, rows=6_000_000, parts=8,
                  profile=True) -> dict:
    """SSB Q2.1 at SF 1 (see the module docstring, phase 3c)."""
    from tensorframes_tpu_torch.engine.ops import (
        _blockwise_key_factorization)
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters
    join_mod = importlib.import_module(
        "tensorframes_tpu_torch.relational.join")

    t0 = time.perf_counter()
    tables = ssb_tables(np, rows)
    gen_s = time.perf_counter() - t0
    lineorder, date, part, supplier = tables
    t0 = time.perf_counter()
    want = {q: ssb_reference(np, tables, q) for q in (True, False)}
    reference_s = time.perf_counter() - t0

    # every gather reports the names it moved, and the build tensors it
    # read must be resident on the card
    gathered = []
    real_gather = join_mod.BuildTable.gather_device

    def spy(self, names, idx, gid, executor=None):
        out = real_gather(self, names, idx, gid, executor=executor)
        assert all(self.dev_cols[n].device.type == ttf.default_device().type
                   for n in out), "a build column was not resident"
        if out:
            gathered.append(tuple(sorted(out)))
        return out

    names = ("plan.fused_queries", "relational.probe_dispatches")

    def run(fuse=True, q21=True, sort_merge=False):
        prior = os.environ.get("TFT_FUSE")
        os.environ["TFT_FUSE"] = "1" if fuse else "0"
        try:
            c0 = {k: counters.get(k) for k in names}
            s0 = tracing.timings.snapshot()
            l0 = segment_reduce.launches
            del gathered[:]
            t0 = time.perf_counter()
            # the build tables are made (and copied to the card) here
            ch = ssb_chain(ttf, tables, parts, q21, sort_merge)
            build_s = time.perf_counter() - t0
            cols = ssb_aggregate(ttf, ch).blocks()[0].columns
            wall = time.perf_counter() - t0
        finally:
            if prior is None:
                del os.environ["TFT_FUSE"]
            else:
                os.environ["TFT_FUSE"] = prior
        s1 = tracing.timings.snapshot()
        spans = {k: {"count": v["count"] - s0.get(k, {}).get("count", 0),
                     "total_s": v["total_s"] - s0.get(k, {}).get("total_s",
                                                                   0.0)}
                 for k, v in s1.items()
                 if v["count"] > s0.get(k, {}).get("count", 0)}
        block_rows = [b.num_rows for b in ch.blocks()]  # cached
        return {"cols": cols, "plan": ch._plan_info, "wall_s": wall,
                "rows_out": sum(block_rows), "block_rows": block_rows,
                "build_s": build_s, "gathered": sorted(set(gathered)),
                "counts": {k: counters.get(k) - c0[k] for k in names},
                "launches": segment_reduce.launches - l0, "spans": spans}

    def same(a, b) -> bool:
        return all(np.array_equal(a[k], b[k]) for k in want[True])

    join_mod.BuildTable.gather_device = spy
    try:
        cold = run()
        timed = {True: [], False: []}
        for fuse in SSB_ORDER:
            timed[fuse].append(run(fuse))
        rollup = run(q21=False)
        smj = run(sort_merge=True)
    finally:
        join_mod.BuildTable.gather_device = real_gather

    def force():
        ch = ssb_chain(ttf, tables, parts, True, False)
        return ch.blocks() + ssb_aggregate(ttf, ch).blocks()

    default = default_forcings(np, force)
    for q, r in ((True, cold), (False, rollup)):
        for k, col in want[q].items():
            assert r["cols"][k].dtype == col.dtype, (k, r["cols"][k].dtype)
            np.testing.assert_array_equal(r["cols"][k], col)
    assert len(want[True]["d_year"]) == 280, len(want[True]["d_year"])
    assert len(want[False]["d_year"]) == 7000
    for r in timed[True] + timed[False]:
        assert same(r["cols"], cold["cols"]), "fused and TFT_FUSE=0 differ"
    assert same(smj["cols"], cold["cols"]), "sort-merge != broadcast"
    for r in [cold] + timed[True]:
        assert r["plan"], "the chain over the joins did not fuse"
        assert r["counts"]["plan.fused_queries"] >= 1, r["counts"]
        # three joins, one gather per block each, of the named columns only
        assert r["counts"]["relational.probe_dispatches"] == 3 * parts
        assert r["gathered"] == [("d_year",), ("p_brand1", "p_category"),
                                 ("s_region",)], r["gathered"]
        # host->device: each gather's int32 index and the filter stage's
        # inputs, once per block
        assert r["spans"]["executor.convert"]["count"] == 4 * parts, \
            r["spans"]
        assert r["spans"]["join.probe_gather"]["count"] == 3 * parts
        assert r["spans"]["join.match"]["count"] == 3 * parts
    for r in timed[False]:
        assert r["plan"] is None and r["counts"]["plan.fused_queries"] == 0
        assert ("s_nation", "s_region") in r["gathered"], r["gathered"]
    assert rollup["gathered"] == [("d_year",), ("p_brand1",)], \
        rollup["gathered"]
    assert rollup["counts"]["relational.probe_dispatches"] == 2 * parts
    for r in [cold, rollup, smj] + timed[True] + timed[False]:
        assert r["launches"] == parts, r["launches"]  # B1, once a block

    # HLL of lo_custkey by d_yearmonthnum (84 months, each with its own
    # subset of the customers, so the groups' registers differ): the
    # aggregate's device fold, and its registers against the same blocks
    # folded on the CPU executor and by numpy on the host
    j = ttf.frame(lineorder, num_partitions=parts).join(
        ttf.frame(date), on="lo_orderdate").select(
            ["d_yearmonthnum", "lo_custkey"])
    sk = ttf.approx_distinct(bits=12)
    s0 = tracing.timings.snapshot()
    t0 = time.perf_counter()
    hll = ttf.aggregate({"lo_custkey": sk}, j.group_by("d_yearmonthnum"))
    hll_cols = hll.blocks()[0].columns
    hll_s = time.perf_counter() - t0
    fold = tracing.timings.snapshot()["aggregate.sketch_fold"]
    fold_s = fold["total_s"] - s0.get("aggregate.sketch_fold",
                                      {}).get("total_s", 0.0)
    jb = j.blocks()
    ids_blocks, _, groups = _blockwise_key_factorization(
        jb, ["d_yearmonthnum"])
    sketch_mod = importlib.import_module(
        "tensorframes_tpu_torch.relational.sketch")
    fold_rows = sketch_mod.DEVICE_FOLD_ROWS
    tables_by = {}
    for where in (ttf.default_device().type, "cpu", "numpy"):
        sketch_mod.DEVICE_FOLD_ROWS = 1 << 62 if where == "numpy" \
            else fold_rows
        try:
            t = None
            for b, ids in zip(jb, ids_blocks):
                part_t = sk.block_partial(
                    b.columns["lo_custkey"], ids, groups,
                    device=None if where == "numpy" else where)
                t = part_t if t is None else sk.combine_np(t, part_t)
        finally:
            sketch_mod.DEVICE_FOLD_ROWS = fold_rows
        tables_by[where] = t
    card = tables_by[ttf.default_device().type]
    assert card.dtype == np.int32 and card.shape == (groups, sk.m)
    for where in ("cpu", "numpy"):
        assert np.array_equal(card, tables_by[where]), \
            f"HLL registers differ between the card and {where}"
    # a fold that mixed up group ids would not match: no two months
    # hold the same registers
    assert len(np.unique(card, axis=0)) == groups, "months share registers"
    np.testing.assert_array_equal(hll_cols["lo_custkey"],
                                  sk.finalize("e", card)["e"])
    month = date["d_yearmonthnum"][np.searchsorted(
        date["lo_orderdate"], lineorder["lo_orderdate"])]
    order = np.argsort(month, kind="stable")
    bounds = np.searchsorted(month[order], hll_cols["d_yearmonthnum"])
    bounds = np.append(bounds, len(month))
    hll_err, distinct = [], []
    for g, est in enumerate(hll_cols["lo_custkey"]):
        custs = lineorder["lo_custkey"][order[bounds[g]:bounds[g + 1]]]
        true = len(np.unique(custs))
        distinct.append(true)
        hll_err.append((int(est) - true) / true)
        assert abs(est - true) <= 5 * sk.relative_error * true, \
            (hll_cols["d_yearmonthnum"][g], est, true)

    profiled = None
    if profile:
        profiled = device_breakdown(torch, lambda: run())

    walls = {f: sorted(r["wall_s"] for r in timed[f]) for f in timed}
    keep = ("join.probe", "join.match", "join.probe_gather",
            "aggregate.factorize_keys",
            "aggregate.segment_reduce", "aggregate.sketch_fold",
            "plan.execute", "executor.convert", "executor.dispatch",
            "join.sort_merge")

    def spans_of(r):
        return {k: v for k, v in r["spans"].items() if k in keep}

    return {"config": {"benchmark": "SSB Q2.1", "scale_factor": 1,
                       "lineorder_rows": rows, "partitions": parts,
                       "date_rows": len(date["lo_orderdate"]),
                       "part_rows": len(part["lo_partkey"]),
                       "supplier_rows": len(supplier["lo_suppkey"]),
                       "host_bytes": int(sum(a.nbytes for t in tables
                                             for a in t.values()))},
            "generate_s": gen_s, "reference_s": reference_s,
            "groups": {"q21": len(want[True]["d_year"]),
                       "rollup": len(want[False]["d_year"])},
            "q21_rows_after_filter": cold["rows_out"],
            "q21_block_rows": cold["block_rows"],
            "plan": cold["plan"], "build_s": cold["build_s"],
            "fused_cold_wall_s": cold["wall_s"],
            "default_knobs": default,
            "timed_order": ["fused" if f else "per_op" for f in SSB_ORDER],
            "fused_walls_s": [r["wall_s"] for r in timed[True]],
            "unfused_walls_s": [r["wall_s"] for r in timed[False]],
            "fused_median_s": float(np.median(walls[True])),
            "unfused_median_s": float(np.median(walls[False])),
            "rows_per_s_fused": rows / float(np.median(walls[True])),
            "rows_per_s_unfused": rows / float(np.median(walls[False])),
            "rollup_wall_s": rollup["wall_s"],
            "sort_merge_wall_s": smj["wall_s"],
            "hll": {"wall_s": hll_s, "sketch_fold_s": fold_s,
                    "groups": int(groups), "registers": int(sk.m),
                    "distinct_min_max": [min(distinct), max(distinct)],
                    "relative_error_min_max": [min(hll_err), max(hll_err)],
                    "relative_error_mean_abs": float(np.mean(np.abs(
                        hll_err)))},
            "segment_sum_launches": {
                "cold": cold["launches"], "rollup": rollup["launches"],
                "sort_merge": smj["launches"]},
            "probe_dispatches": {
                "fused": cold["counts"]["relational.probe_dispatches"],
                "unfused": timed[False][0]["counts"][
                    "relational.probe_dispatches"],
                "rollup": rollup["counts"]["relational.probe_dispatches"]},
            "gathered": {"fused": cold["gathered"],
                         "unfused": timed[False][0]["gathered"],
                         "rollup": rollup["gathered"]},
            "spans_fused_cold": spans_of(cold),
            "spans_fused_warm": spans_of(timed[True][0]),
            "spans_unfused": spans_of(timed[False][0]),
            "spans_rollup": spans_of(rollup),
            "spans_sort_merge": spans_of(smj),
            "fused_profile": profiled}


def rff_tables(np, rows, d=16, feats=4096, keys=100_000, seed=6,
               dtype="float32") -> dict:
    """The OOM phase's data from a numpy seed: ``x`` [rows, d] N(0, 1),
    ``key`` int64 in [0, keys), and the random Fourier features of a
    Gaussian kernel (Rahimi and Recht, NIPS 2007) the program closes over:
    ``W`` [d, feats] N(0, 1), ``b`` U(0, 2 pi), ``beta`` N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, d), dtype=np.float32)
            .astype(dtype),
            "key": rng.integers(0, keys, rows),
            "W": rng.standard_normal((d, feats)).astype(dtype),
            "b": rng.uniform(0.0, 2 * np.pi, feats).astype(dtype),
            "beta": rng.standard_normal(feats).astype(dtype)}


def rff_query(m, cos, consts, tables, partitions) -> tuple:
    """``frame -> map_rows(z = cos(x @ W + b) @ beta / sqrt(F)) -> select
    -> aggregate({"z": "sum"})`` by ``key`` through package ``m`` (the port
    or, in the tests, the JAX package), with ``consts`` = (W, b, beta) as
    that package's arrays and ``cos`` its cosine. Lazy up to the
    aggregate, which forces the map as one fused row-local stage. Returns
    ``(selected frame, aggregate)``."""
    W, b, beta = consts
    scale = 1.0 / float(tables["W"].shape[1]) ** 0.5
    df = m.frame({"key": tables["key"], "x": tables["x"]},
                 num_partitions=partitions)
    sel = df.map_rows(lambda x: {"z": (cos(x @ W + b) @ beta) * scale}) \
        .select(["key", "z"])
    return sel, m.aggregate({"z": "sum"}, sel.group_by("key"))


def rff_reference(np, tables, rows) -> "np.ndarray":
    """``z`` of ``rows`` in f64 numpy."""
    f64 = {k: np.asarray(tables[k], np.float64) for k in ("W", "b", "beta")}
    x = tables["x"][rows].astype(np.float64)
    return np.cos(x @ f64["W"] + f64["b"]) @ f64["beta"] \
        / np.sqrt(f64["W"].shape[1])


def rff_splits(rows, d, feats, cap_bytes) -> int:
    """The splits a block of ``rows`` takes under ``cap_bytes``, by the
    program's memory: ``x @ W`` and ``+ b`` hold two [rows, feats] f32
    tensors at once (so does ``cos``), beside the [rows, d] input. A
    block that does not fit halves, recursively."""
    if 2 * rows * feats * 4 + rows * d * 4 <= cap_bytes or rows < 2:
        return 0
    return 1 + rff_splits(rows // 2, d, feats, cap_bytes) \
        + rff_splits(rows - rows // 2, d, feats, cap_bytes)


def ledger_spills(est, blocks, depth, limit, resident=()) -> dict:
    """The ledger counters a pipelined stream of ``blocks`` blocks, each
    admitted at ``est`` bytes, takes at ``depth`` under a ``limit``-byte
    budget, by the memory manager's rules: a submit reserves with
    ``try_reserve``, which spills the least recently used resident entry
    (first ``resident``, the bytes already registered, then the pending
    blocks, oldest first) while the reservation does not fit; the
    reservation becomes a resident entry until its block drains, which
    happens once ``depth`` blocks are in the window; a submit that
    nothing can make room for runs synchronously (a sync dispatch) and
    holds nothing."""
    entries = [[b, "resident"] for b in resident]  # LRU first
    window = []
    spills = syncs = 0
    for _ in range(blocks):
        while sum(e[0] for e in entries) + est > limit:
            victim = next((e for e in entries if e[0] > 0), None)
            if victim is None:
                break
            victim[0] = 0
            spills += 1
        if sum(e[0] for e in entries) + est > limit:
            syncs += 1
            window.append(None)
        else:
            entry = [est, "pending"]
            entries.append(entry)
            window.append(entry)
        if len(window) >= depth:
            done = window.pop(0)
            if done is not None:
                entries = [e for e in entries if e is not done]
    return {"memory.spills": spills, "memory.sync_dispatches": syncs}


def phase_oom_recovery_rff(ttf, np, torch, segment_reduce, n=20_000_000,
                           parts=8, d=16, feats=4096, keys=100_000,
                           cap_gib=24.0, sample=10_000) -> dict:
    """The executor's recovery from a real ``torch.cuda.OutOfMemoryError``.

    The reference workload's 20M rows in 8 partitions with an f32 vector
    cell ``x`` of 16 features and an int64 ``key`` in [0, 100,000); a
    row-local ``map_rows`` of random Fourier features, ``z = cos(x @ W +
    b) @ beta / sqrt(4096)``, then ``aggregate({"z": "sum"})`` by key,
    with the process capped at 24 GiB by
    ``torch.cuda.set_per_process_memory_fraction`` (put back to 1.0 in a
    ``finally``). One block's [2.5M, 4096] f32 product is 40.96 GB: every
    block's submit fails at its first product, its drain splits it at
    once (a sync fallback, with no second whole-block attempt), the
    1.25M-row halves fail at the add and the 625k-row quarters fit
    (:func:`rff_splits`). Checks, none
    caught: ``z`` bit-equal to the chain without the cap over the same
    rows in 32 partitions of 625,000 (the split's leaf shapes, the same
    cuBLAS calls); ``z`` within rtol and atol 1e-4 of f64 numpy on 10,000
    rows drawn from the seed; the keyed sums (B1 in f32) within 1e-5 of
    the group's sum of ``|z|`` from numpy's f64 sums of the ``z`` the card
    returned (the f32 summation bound: the sums cancel, so a bound
    relative to the sum itself is not one); the counters as the memory
    model predicts; the aggregate's trace holding one ``oom_split`` event,
    each under the cap, and one ``engine.oom_split`` flight record under
    its query id, per split. Then four injected drills on ``map_rows(z =
    x + x)`` over the reference workload's f64 column, uncapped, each
    bit-equal to the undisturbed run: one OOM (one split), two transient
    dispatch faults (two retries), one drain fault at depth 3 (one sync
    fallback), and ten dispatch faults (a giveup with ``InjectedFault``).
    """
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch.observability import flight
    from tensorframes_tpu_torch.resilience import InjectedFault, faults
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    dev = ttf.default_device()
    if dev.type == "cuda" and dev.index is None:  # the memory calls want one
        dev = torch.device(dev.type, torch.cuda.current_device())
    tables = rff_tables(np, n, d, feats, keys)
    consts = tuple(torch.from_numpy(tables[k]).to(dev)
                   for k in ("W", "b", "beta"))
    cap = int(cap_gib * (1 << 30))
    predicted = {"oom_split.dispatches":
                 parts * rff_splits(n // parts, d, feats, cap),
                 "pipeline.sync_fallbacks": parts,
                 "plan.oom_fallbacks": 0,
                 "segment_sum_launches": parts}
    names = ("oom_split.dispatches", "pipeline.sync_fallbacks",
             "plan.oom_fallbacks", "retry.executor.dispatch.retries",
             "retry.executor.dispatch.giveups")

    def counts():
        return {k: counters.get(k) for k in names}

    def spans_since(before):
        return {k: {"count": v["count"] - before.get(k, {}).get("count", 0),
                    "total_s": v["total_s"]
                    - before.get(k, {}).get("total_s", 0.0)}
                for k, v in tracing.timings.snapshot().items()
                if v["count"] > before.get(k, {}).get("count", 0)}

    # the capped query
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        c0, s0, l0 = counts(), tracing.timings.snapshot(), \
            segment_reduce.launches
        flight.clear()
        t0 = time.perf_counter()
        sel, agg = rff_query(ttf, torch.cos, consts, tables, parts)
        trace = obs.last_query()  # the eager aggregate's
        cols = agg.blocks()[0].columns
        torch.cuda.synchronize()
        capped_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    got = {k: counters.get(k) - c0[k] for k in names}
    got["segment_sum_launches"] = segment_reduce.launches - l0
    spans_capped = spans_since(s0)
    z = np.concatenate([b.columns["z"] for b in sel.blocks()])
    assert z.dtype == np.float32 and z.shape == (n,), (z.dtype, z.shape)
    assert np.isfinite(z).all(), "non-finite z"
    for k, v in predicted.items():
        assert got[k] == v, f"{k}: {got[k]}, predicted {v}"
    assert got["oom_split.dispatches"] >= parts, "a block did not split"
    assert peak <= cap, f"peak {peak} B over the {cap} B cap"

    # 5, 6: the trace and the flight ring of the capped query
    assert trace is not None and trace.op == "aggregate", trace
    splits = [e for e in trace.events if e.etype == "oom_split"]
    assert len(splits) == got["oom_split.dispatches"], len(splits)
    for e in splits:
        assert 0 < e.args["hbm_live_bytes"] <= cap, e.args
        assert e.args["hbm_peak_bytes"] <= cap, e.args
        assert e.args["error"] == "OutOfMemoryError", e.args
    recs = [r for r in flight.for_query(trace.query_id)
            if r["kind"] == "engine.oom_split"]
    assert len(recs) == got["oom_split.dispatches"], len(recs)
    assert sorted(r["rows"] for r in recs) == sorted(
        e.args["rows"] for e in splits)

    # 1: bit-equal to the uncapped chain over the split's leaf shapes
    leaf_parts = parts
    rows = n // parts
    while 2 * rows * feats * 4 + rows * d * 4 > cap:
        rows //= 2
        leaf_parts *= 2
    t0 = time.perf_counter()
    sel2, agg2 = rff_query(ttf, torch.cos, consts, tables, leaf_parts)
    cols2 = agg2.blocks()[0].columns
    torch.cuda.synchronize()
    uncapped_wall = time.perf_counter() - t0
    z2 = np.concatenate([b.columns["z"] for b in sel2.blocks()])
    assert [b.num_rows for b in sel2.blocks()] == [rows] * leaf_parts
    assert np.array_equal(z.view(np.uint32), z2.view(np.uint32)), \
        "z under the cap is not bit-equal to the uncapped leaf-shape run"

    # 2: against f64 numpy on rows drawn from the seed
    idx = np.random.default_rng(61).choice(n, sample, replace=False)
    want_z = rff_reference(np, tables, idx)
    np.testing.assert_allclose(z[idx], want_z, rtol=1e-4, atol=1e-4)

    # 3: the keyed sums (B1, f32) against numpy's f64 sums of that z
    want = np.bincount(tables["key"], weights=z.astype(np.float64),
                       minlength=keys)
    scale = np.bincount(tables["key"], weights=np.abs(z.astype(np.float64)),
                        minlength=keys)
    np.testing.assert_array_equal(cols["key"], np.arange(keys))
    assert cols["z"].dtype == np.float32
    err = np.abs(cols["z"].astype(np.float64) - want)
    assert (err <= 1e-5 * scale).all(), float(np.max(err / scale))
    np.testing.assert_array_equal(cols2["key"], cols["key"])
    assert (np.abs(cols2["z"].astype(np.float64) - want)
            <= 1e-5 * scale).all(), "the uncapped run's keyed sums"

    # the drills: map_rows(z = x + x) over the reference workload's f64
    # column, uncapped
    rng = np.random.default_rng(2)
    x64 = rng.random(n)
    dfx = ttf.frame({"x": x64}, num_partitions=parts)

    def drill(site=None, fail_n=0, depth=1):
        prior = os.environ.get("TFT_PIPELINE_DEPTH")
        os.environ["TFT_PIPELINE_DEPTH"] = str(depth)
        c = counts()
        try:
            out = dfx.map_rows(lambda x: {"z": x + x})
            if site is None:
                got_z = np.concatenate([b.columns["z"] for b in out.blocks()])
            else:
                with faults.inject(site, fail_n=fail_n):
                    got_z = np.concatenate([b.columns["z"]
                                            for b in out.blocks()])
        finally:
            if prior is None:
                del os.environ["TFT_PIPELINE_DEPTH"]
            else:
                os.environ["TFT_PIPELINE_DEPTH"] = prior
        return got_z, {k: counters.get(k) - c[k] for k in names}

    base, _ = drill()
    assert np.array_equal(base, 2 * x64)
    drills = {}
    for label, site, fail_n, depth, key, want_n in (
            ("oom", "oom", 1, 1, "oom_split.dispatches", 1),
            ("dispatch", "dispatch", 2, 1,
             "retry.executor.dispatch.retries", 2),
            ("drain", "drain", 1, 3, "pipeline.sync_fallbacks", 1)):
        zd, cd = drill(site, fail_n, depth)
        assert cd[key] == want_n, (label, cd)
        assert np.array_equal(zd.view(np.uint64), base.view(np.uint64)), \
            f"drill {label} is not bit-equal to the undisturbed run"
        drills[label] = cd
    g0 = counters.get("retry.executor.dispatch.giveups")
    try:
        drill("dispatch", 10, 1)
        raise AssertionError("ten dispatch faults did not give up")
    except InjectedFault as e:
        assert str(e) == "injected transient fault at site 'dispatch'", e
    assert counters.get("retry.executor.dispatch.giveups") - g0 == 1
    drills["giveup"] = {"retry.executor.dispatch.giveups": 1,
                        "error": "InjectedFault"}

    print_card()
    return {"rows": n, "partitions": parts, "features": feats,
            "keys": keys, "cap_bytes": cap, "peak_bytes": peak,
            "counters": got, "predicted": predicted,
            "capped_wall_s": capped_wall, "uncapped_wall_s": uncapped_wall,
            "uncapped_partitions": leaf_parts,
            "oom_split_s": spans_capped["executor.oom_split"]["total_s"],
            "factorize_keys_s":
                spans_capped["aggregate.factorize_keys"]["total_s"],
            "spans_capped": spans_capped,
            "trace_oom_split_events": len(splits),
            "flight_oom_split_records": len(recs),
            "z_max_abs_err_vs_f64": float(np.max(np.abs(z[idx] - want_z))),
            "sum_max_err_over_abs_sum": float(np.max(err / scale)),
            "drills": drills}


def jl_tables(np, rows, feats=64, proj=16, keys=100_000, seed=7,
              streams=8) -> dict:
    """The budget phase's data from a numpy seed: ``x`` [rows, feats] f32
    N(0, 1), ``key`` int64 in [0, keys), and ``P`` [feats, proj] f32, a
    Johnson-Lindenstrauss random projection N(0, 1 / proj), so that
    ``((x @ P) ** 2).sum(-1)`` estimates ``|x|^2``. ``x`` is filled by
    ``streams`` generators spawned from the seed, one a thread, one
    contiguous slice each."""
    from concurrent.futures import ThreadPoolExecutor

    seqs = np.random.SeedSequence(seed).spawn(streams + 1)
    rng = np.random.default_rng(seqs[-1])
    x = np.empty((rows, feats), np.float32)
    bounds = np.linspace(0, rows, streams + 1).astype(np.int64)

    def fill(args):
        seq, a, b = args
        np.random.default_rng(seq).standard_normal(out=x[a:b],
                                                   dtype=np.float32)

    with ThreadPoolExecutor(streams) as pool:
        list(pool.map(fill, zip(seqs[:-1], bounds[:-1], bounds[1:])))
    return {"x": x, "key": rng.integers(0, keys, rows),
            "P": (rng.standard_normal((feats, proj))
                  / np.sqrt(proj)).astype(np.float32)}


def jl_select(m, P, tables, partitions):
    """``frame -> map_rows(z = ((x @ P) ** 2).sum(-1)) -> select`` through
    package ``m`` with ``P`` its array: lazy."""
    df = m.frame({"key": tables["key"], "x": tables["x"]},
                 num_partitions=partitions)
    return df.map_rows(lambda x: {"z": ((x @ P) ** 2).sum(-1)}) \
        .select(["key", "z"])


def jl_aggregate(m, sel):
    """``aggregate({"z": "sum"})`` of ``sel`` by ``key`` (forces it)."""
    return m.aggregate({"z": "sum"}, sel.group_by("key"))


def proactive_splits(rows, row_bytes, limit) -> int:
    """The proactive splits a row-local block of ``rows`` takes under a
    ``limit``-byte ledger: its estimate is 2x its input bytes, and a block
    whose estimate alone is over the limit halves, recursively."""
    if 2 * rows * row_bytes <= limit or rows < 2:
        return 0
    return 1 + proactive_splits(rows // 2, row_bytes, limit) \
        + proactive_splits(rows - rows // 2, row_bytes, limit)


def phase_memory_budget(ttf, np, torch, segment_reduce, n=20_000_000,
                        parts=8, feats=64, proj=16, keys=100_000,
                        cap_gib=8.0, ssb_rows=6_000_000,
                        sample=10_000) -> dict:
    """The port under a device-memory ledger, as users sharing a card run
    it (module docstring, phase 3e).

    The process is capped at ``cap_gib`` GiB with
    ``torch.cuda.set_per_process_memory_fraction`` (put back to 1.0 in a
    ``finally``) and the ledger reads its budget from that cap x the
    default ``TFT_MEM_FRACTION`` 0.85. The data: 20M rows of an f32 cell
    ``x`` of 64 features (5.12 GB) and an int64 ``key`` in [0, 100,000);
    the program ``z = ((x @ P) ** 2).sum(-1)``, then ``aggregate({"z":
    "sum"})`` by key through segment_sum. (a) one 20M-row partition: its
    estimate (2 x 5.12 GB) is over the budget, so the executor splits it
    once before dispatch and no allocation fails; (b) 8 partitions at
    ``TFT_PIPELINE_DEPTH=8``: five 1.28 GB estimates fit, and each later
    submit spills the oldest pending block (:func:`ledger_spills`); (c)
    (b) in a ``PreemptionScope`` with three injected preemptions and
    ``TFT_PERSIST_DIR`` set: three parks at strictly later blocks, each
    written to disk, each resume dispatching only the blocks past its
    checkpoint; then a cancel from another thread mid-stream raises
    ``QueryCancelled``, frees the checkpoint and gives the card back to
    its memory before the query; (d) SSB Q2.1 at SF 1 leaves its three
    build tables resident in the ledger, (b) spills them first (the
    coldest), and Q2.1 collected again from the same frame faults them
    back; then Q2.1 under a 4 MB ledger probes its part build in chunks.
    Checks, none caught: the counters as predicted; ``z`` bit-equal across
    (a), (b), (c) and the unbudgeted runs, and within 1e-4 of f64 numpy
    on ``sample`` rows; the keyed sums bit-equal to the unbudgeted run of
    the same partitioning, and within 1e-5 of f64 numpy relative to the
    group's sum of ``|z|``; Q2.1 equal to its numpy reference each time;
    the peak allocation under the cap."""
    import gc
    import shutil
    import tempfile
    import threading

    from tensorframes_tpu_torch import memory
    from tensorframes_tpu_torch.engine import preempt
    from tensorframes_tpu_torch.memory import persist
    from tensorframes_tpu_torch.resilience import (QueryCancelled,
                                                   QueryPreempted, faults)
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    assert not os.environ.get("TFT_MEM_LIMIT_BYTES"), \
        "the phase reads its budget from the cap, not TFT_MEM_LIMIT_BYTES"
    dev = ttf.default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    names = ("memory.proactive_splits", "oom_split.dispatches",
             "memory.spills", "memory.spill_bytes", "memory.faults",
             "memory.fault_bytes", "memory.sync_dispatches",
             "memory.admission_waits", "memory.overflow_admissions",
             "pipeline.submitted", "pipeline.parked_blocks",
             "pipeline.resumed_blocks", "pipeline.preempted_streams",
             "pipeline.cancelled_streams", "persist.checkpoint_writes",
             "relational.build_chunks")

    def counts():
        return {k: counters.get(k) for k in names}

    def delta(c0):
        return {k: counters.get(k) - c0[k] for k in names
                if counters.get(k) != c0[k]}

    def spans_since(before, keys):
        now = tracing.timings.snapshot()
        return {k: {"count": now.get(k, {}).get("count", 0)
                    - before.get(k, {}).get("count", 0),
                    "total_s": now.get(k, {}).get("total_s", 0.0)
                    - before.get(k, {}).get("total_s", 0.0)}
                for k in keys}

    def zs(sel):
        return np.concatenate([b.columns["z"] for b in sel.blocks()])

    def run(partitions):
        """One chain and its aggregate: ``(z, sums, wall)``."""
        t0 = time.perf_counter()
        sel = jl_select(ttf, P, tables, partitions)
        cols = jl_aggregate(ttf, sel).blocks()[0].columns
        torch.cuda.synchronize()
        return zs(sel), cols, time.perf_counter() - t0

    t0 = time.perf_counter()
    tables = jl_tables(np, n, feats, proj, keys)
    P = torch.from_numpy(tables["P"]).to(dev)
    data_s = time.perf_counter() - t0

    # the unbudgeted runs of the same chain, one and eight partitions
    memory.configure(limit_bytes=0)
    z1, ref1, ref1_wall = run(1)
    z8, ref8, ref8_wall = run(parts)
    assert z1.dtype == np.float32 and z1.shape == (n,)
    assert np.isfinite(z1).all(), "non-finite z"
    assert np.array_equal(z1.view(np.uint32), z8.view(np.uint32)), \
        "z of one 20M-row block differs from z of eight 2.5M-row blocks"
    idx = np.random.default_rng(71).choice(n, sample, replace=False)
    x64 = tables["x"][idx].astype(np.float64)
    want_z = ((x64 @ tables["P"].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(z1[idx], want_z, rtol=1e-4, atol=1e-4)
    want = np.bincount(tables["key"], weights=z1.astype(np.float64),
                       minlength=keys)
    scale = np.bincount(tables["key"],
                        weights=np.abs(z1.astype(np.float64)),
                        minlength=keys)

    def sums_ok(cols, what):
        np.testing.assert_array_equal(cols["key"], np.arange(keys))
        assert cols["z"].dtype == np.float32, what
        err = np.abs(cols["z"].astype(np.float64) - want)
        assert (err <= 1e-5 * scale).all(), (what, float(np.max(err / scale)))
        return float(np.max(err / scale))

    rel_err = {"unbudgeted_1": sums_ok(ref1, "unbudgeted 1 partition"),
               "unbudgeted_8": sums_ok(ref8, "unbudgeted 8 partitions")}

    def same_sums(cols, ref, what):
        assert np.array_equal(cols["z"].view(np.uint32),
                              ref["z"].view(np.uint32)), \
            f"{what}: keyed sums not bit-equal to the unbudgeted run"

    cap = int(cap_gib * (1 << 30))
    total = torch.cuda.get_device_properties(dev).total_memory
    depth_prior = os.environ.get("TFT_PIPELINE_DEPTH")
    persist_prior = os.environ.get("TFT_PERSIST_DIR")
    persist_dir = tempfile.mkdtemp(prefix="tft-persist-")
    out = {"rows": n, "partitions": parts, "features": feats, "keys": keys,
           "cap_bytes": cap, "data_s": data_s,
           "unbudgeted_wall_s": {"1": ref1_wall, "8": ref8_wall}}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        mgr = memory.configure()  # the cap x TFT_MEM_FRACTION
        limit_seen = torch.cuda.get_per_process_memory_fraction(dev) * total
        out["budget_bytes"] = mgr.limit
        out["budget_predicted"] = int(int(limit_seen) * 0.85)
        out["budget_for_8_gib"] = int(cap * 0.85)
        print(json.dumps({"cap_bytes": cap, "budget_bytes": mgr.limit,
                          "snapshot": mgr.snapshot()}), flush=True)
        assert mgr.limit == out["budget_predicted"], out
        # the fraction cap / total is a float: the allocator's limit
        # (total x fraction, truncated) may fall a few bytes under the cap
        assert 0 <= int(cap * 0.85) - mgr.limit <= 16, out
        torch.cuda.reset_peak_memory_stats(dev)
        oom0 = counters.get("oom_split.dispatches")

        # (a) one 20M-row block over the budget: split before dispatch
        c0, s0 = counts(), tracing.timings.snapshot()
        l0 = segment_reduce.launches
        za, cols_a, wall_a = run(1)
        got = delta(c0)
        pred = {"memory.proactive_splits":
                proactive_splits(n, feats * 4, mgr.limit),
                "oom_split.dispatches": 0}
        for k, v in pred.items():
            assert got.get(k, 0) == v, (k, got, pred)
        assert segment_reduce.launches - l0 == 1
        assert np.array_equal(za.view(np.uint32), z1.view(np.uint32))
        same_sums(cols_a, ref1, "(a)")
        rel_err["a"] = sums_ok(cols_a, "(a)")
        out["a"] = {"wall_s": wall_a, "counters": got, "predicted": pred,
                    "segment_sum_launches": segment_reduce.launches - l0,
                    "spans": spans_since(s0, ("executor.proactive_split",
                                              "executor.dispatch",
                                              "aggregate.segment_reduce"))}
        del za

        # (b) eight 2.5M-row blocks at depth 8: the window spills
        os.environ["TFT_PIPELINE_DEPTH"] = "8"
        est = 2 * (n // parts) * feats * 4
        c0 = counts()
        zb, cols_b, wall_b = run(parts)
        got = delta(c0)
        pred = ledger_spills(est, parts, 8, mgr.limit)
        for k, v in pred.items():
            assert got.get(k, 0) == v, (k, got, pred)
        assert got.get("memory.spill_bytes", 0) == \
            pred["memory.spills"] * est
        assert np.array_equal(zb.view(np.uint32), z8.view(np.uint32))
        same_sums(cols_b, ref8, "(b)")
        rel_err["b"] = sums_ok(cols_b, "(b)")
        out["b"] = {"wall_s": wall_b, "counters": got, "predicted": pred,
                    "estimate_bytes": est}
        del zb

        # (b') (b)'s chain with a second row-local op, so that it takes
        # the plan, under the same budget and depth with the adaptive
        # layout at its default: the ledger's per-block ceiling splits
        # its 660 MB blocks, bit-identical to the static layout
        def force():
            sel = jl_select(ttf, P, tables, parts).map_rows(
                lambda z: {"w": z + 1.0}).select(["key", "z", "w"])
            return sel.blocks() + jl_aggregate(
                ttf, sel.select(["key", "z"])).blocks()

        c0 = counts()
        out["b_default_knobs"] = default_forcings(np, force)
        out["b_default_knobs"]["ledger"] = delta(c0)

        # (c) preemption: three parks, resumes, then a cancel
        os.environ["TFT_PERSIST_DIR"] = persist_dir
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        sel = jl_select(ttf, P, tables, parts)
        scope = preempt.PreemptionScope("memory_budget_c")
        faults.arm("preempt", 3)
        attempts = []
        try:
            for _ in range(6):
                c0 = counts()
                t0 = time.perf_counter()
                try:
                    with preempt.activate(scope):
                        cols_c = jl_aggregate(ttf, sel).blocks()[0].columns
                except QueryPreempted:
                    cp = scope.checkpoint
                    attempts.append({
                        "parked": cp.parked_blocks,
                        "wall_s": time.perf_counter() - t0,
                        "counters": delta(c0),
                        "moved_device_bytes": cp.moved_bytes,
                        "persist": persist.stats()})
                    # the park left nothing of the query on the card
                    torch.cuda.synchronize()
                    attempts[-1]["allocated_after"] = \
                        torch.cuda.memory_allocated(dev)
                    assert attempts[-1]["allocated_after"] == base, \
                        (attempts[-1], base)
                    continue
                torch.cuda.synchronize()
                attempts.append({"parked": "done",
                                 "wall_s": time.perf_counter() - t0,
                                 "counters": delta(c0)})
                break
        finally:
            faults.reset()
        cursors = [a["parked"] for a in attempts]
        assert cursors == [1, 2, 3, "done"], cursors
        prev = 0
        for a, nxt in zip(attempts, [1, 2, 3, parts]):
            cnt = a["counters"]
            assert cnt.get("pipeline.resumed_blocks", 0) == prev, a
            assert cnt.get("pipeline.submitted", 0) == nxt - prev, a
            if a["parked"] != "done":
                assert cnt.get("persist.checkpoint_writes") == 1, a
                assert a["persist"]["checkpoints"] == 1, a
                assert cnt.get("pipeline.parked_blocks") == a["parked"], a
            prev = nxt if a["parked"] != "done" else prev
        assert attempts[-1]["counters"]["pipeline.submitted"] == parts - 3
        zc = zs(sel)
        assert np.array_equal(zc.view(np.uint32), z8.view(np.uint32))
        same_sums(cols_c, ref8, "(c)")
        rel_err["c"] = sums_ok(cols_c, "(c)")

        # a cancel from another thread while the resumed stream runs
        sel_x = jl_select(ttf, P, tables, parts)
        scope_x = preempt.PreemptionScope("memory_budget_cancel")
        faults.arm("preempt", 1)
        try:
            with preempt.activate(scope_x):
                jl_aggregate(ttf, sel_x)
            raise AssertionError("the injected preemption did not park")
        except QueryPreempted:
            pass
        finally:
            faults.reset()
        assert not scope_x.checkpoint.empty
        start = counters.get("pipeline.submitted")
        stop = threading.Event()

        def canceller():
            while counters.get("pipeline.submitted") < start + 2 \
                    and not stop.is_set():
                time.sleep(0.001)
            scope_x.request_cancel("from another thread")

        th = threading.Thread(target=canceller)
        th.start()
        t0 = time.perf_counter()
        cancel_msg = None
        try:
            with preempt.activate(scope_x):
                jl_aggregate(ttf, sel_x)
        except QueryCancelled as e:
            cancel_msg = str(e)
        finally:
            stop.set()
            th.join(timeout=120)
        assert not th.is_alive()
        cancel_wall = time.perf_counter() - t0
        assert cancel_msg is not None, "the stream finished before the cancel"
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(dev)
        assert scope_x.checkpoint.empty, "the cancel kept the checkpoint"
        assert after == base, (after, base)
        out["c"] = {"attempts": attempts, "cancel": {
            "message": cancel_msg, "wall_s": cancel_wall,
            "submitted_before_cancel":
                counters.get("pipeline.submitted") - start,
            "allocated_before_query": base, "allocated_after": after},
            "persist": persist.stats()}
        del zc, sel, sel_x
        os.environ.pop("TFT_PERSIST_DIR")

        # (d) the LRU across queries: SSB's builds, then (b), then SSB
        # again from the same frame
        os.environ.pop("TFT_PIPELINE_DEPTH")
        ssb = ssb_tables(np, ssb_rows)
        ssb_want = ssb_reference(np, ssb, True)

        def ssb_ok(cols, what):
            for k, col in ssb_want.items():
                np.testing.assert_array_equal(cols[k], col, err_msg=what)

        t0 = time.perf_counter()
        chain, agg1 = ssb_query(ttf, ssb, parts)
        q1 = agg1.blocks()[0].columns
        ssb_first_s = time.perf_counter() - t0
        ssb_ok(q1, "Q2.1 under the budget")
        _, date, part, supplier = ssb
        # each build's value columns (all but its key) lie on the card
        build_bytes = [sum(int(v.nbytes) for j, v in enumerate(t.values())
                           if j) for t in (date, part, supplier)]
        snap = mgr.snapshot()
        assert snap["resident_buffers"] == 3, snap
        assert snap["resident_bytes"] == sum(build_bytes), (snap,
                                                             build_bytes)
        os.environ["TFT_PIPELINE_DEPTH"] = "8"
        c0 = counts()
        zd, cols_d, wall_d = run(parts)
        got_b = delta(c0)
        os.environ.pop("TFT_PIPELINE_DEPTH")
        pred = ledger_spills(est, parts, 8, mgr.limit, resident=build_bytes)
        for k, v in pred.items():
            assert got_b.get(k, 0) == v, (k, got_b, pred)
        assert np.array_equal(zd.view(np.uint32), z8.view(np.uint32))
        same_sums(cols_d, ref8, "(d)")
        snap_mid = mgr.snapshot()
        assert snap_mid["spilled_buffers"] == 3, snap_mid
        c0 = counts()
        t0 = time.perf_counter()
        chain.uncache()
        q2 = ssb_aggregate(ttf, chain).blocks()[0].columns
        ssb_again_s = time.perf_counter() - t0
        got_f = delta(c0)
        assert got_f.get("memory.faults", 0) == 3, got_f
        assert got_f.get("memory.fault_bytes", 0) == sum(build_bytes)
        ssb_ok(q2, "Q2.1 after its builds faulted back")
        for k in q1:
            np.testing.assert_array_equal(q2[k], q1[k])
        assert mgr.snapshot()["spilled_buffers"] == 0
        del zd, chain

        # (d') Q2.1 under a 4 MB ledger: the 2.4 MB part build is over its
        # resident threshold (half the budget) and probes in chunks
        memory.configure(limit_bytes=4 << 20)
        c0, s0 = counts(), tracing.timings.snapshot()
        t0 = time.perf_counter()
        _, agg3 = ssb_query(ttf, ssb, parts)
        q3 = agg3.blocks()[0].columns
        chunked_s = time.perf_counter() - t0
        got_c = delta(c0)
        ssb_ok(q3, "Q2.1 with a chunked part build")
        assert got_c.get("relational.build_chunks", 0) == 3, got_c
        peak = torch.cuda.max_memory_allocated(dev)
        assert peak <= cap, f"peak {peak} B over the {cap} B cap"
        # spills hand tensors back to the caching allocator (no
        # cudaFree): no allocation failed under the cap, with no
        # empty_cache between the parts
        assert counters.get("oom_split.dispatches") == oom0
        out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
        out["d"] = {
            "build_bytes": build_bytes, "ssb_first_s": ssb_first_s,
            "b_again_wall_s": wall_d, "b_again_counters": got_b,
            "predicted": {**pred, "memory.faults": 3},
            "ssb_again_s": ssb_again_s, "fault_counters": got_f,
            "chunked_s": chunked_s, "chunked_counters": got_c,
            "spans": spans_since(s0, ("join.probe_gather_chunk",
                                      "join.probe_gather"))}
        out["peak_bytes"] = peak
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        memory._reset()
        faults.reset()
        for key, prior in (("TFT_PIPELINE_DEPTH", depth_prior),
                           ("TFT_PERSIST_DIR", persist_prior)):
            if prior is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = prior
        shutil.rmtree(persist_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["sum_max_err_over_abs_sum"] = rel_err
    out["z_max_abs_err_vs_f64"] = float(np.max(np.abs(z1[idx] - want_z)))
    print_card()
    return out


# the Yahoo Streaming Benchmark's advertising events (Chintapalli et al.,
# IPDPSW 2016; github.com/yahoo/streaming-benchmarks): seven fields, the
# string fields as integer codes, event types view/click/purchase as 0/1/2
YSB_VIEW = 0


def ysb_events(np, n, batch, rate, ads=1_000, users=100_000, seed=21,
               late=1_000) -> tuple:
    """``n`` events in time order at ``rate`` a second, in batches of
    ``batch``; ``late`` more with event times in the first 10 s; and the
    ads table (``ads`` ads, 10 to a campaign)."""
    rng = np.random.default_rng(seed)

    def events(m, times):
        return {"user_id": rng.integers(0, users, m),
                "page_id": rng.integers(0, 1_000, m),
                "ad_id": rng.integers(0, ads, m),
                "ad_type": rng.integers(0, 5, m).astype(np.int32),
                "event_type": rng.integers(0, 3, m).astype(np.int32),
                "event_time": times,
                "ip_address": rng.integers(0, 2 ** 32, m)}

    batches = [events(min(batch, n - s),
                      np.arange(s, min(s + batch, n)) / float(rate))
               for s in range(0, n, batch)]
    late_b = events(late, rng.random(late) * 10.0)
    table = {"ad_id": np.arange(ads, dtype=np.int64),
             "campaign_id": np.arange(ads, dtype=np.int64) // 10}
    return batches, late_b, table


def ysb_reference(np, batches, table, window=10.0) -> dict:
    """numpy's view counts and exact distinct users per (window,
    campaign), and each view's window, campaign and user."""
    views = [b["event_type"] == YSB_VIEW for b in batches]
    w = np.concatenate([np.floor(b["event_time"][v] / window)
                        for b, v in zip(batches, views)]).astype(np.int64)
    c = np.concatenate([table["campaign_id"][b["ad_id"][v]]
                        for b, v in zip(batches, views)])
    u = np.concatenate([b["user_id"][v] for b, v in zip(batches, views)])
    n_w, n_c = int(w.max()) + 1, int(table["campaign_id"].max()) + 1
    counts = np.bincount(w * n_c + c, minlength=n_w * n_c).reshape(n_w, n_c)
    users = int(u.max()) + 1
    pairs = np.unique((w * n_c + c) * users + u) // users
    distinct = np.bincount(pairs, minlength=n_w * n_c).reshape(n_w, n_c)
    return {"counts": counts, "distinct": distinct, "w": w, "c": c,
            "u": u}


def ysb_query(ttf, torch, source, table, distinct=False):
    """The benchmark's query over ``source``: views, joined to their
    campaigns, counted per campaign per 10 s window (as an f64 sum of
    ones, so that the fold is a float sum); ``distinct`` adds the
    distinct users."""
    from tensorframes_tpu_torch import stream

    keep = ["campaign_id", "event_time", "n"] + (["user_id"]
                                                  if distinct else [])
    fetches = {"n": "sum"}
    if distinct:
        fetches["user_id"] = ttf.relational.approx_distinct()
    return (stream.from_source(source)
            .filter_rows(lambda event_type: event_type == YSB_VIEW)
            .join(ttf.frame(dict(table)), on="ad_id", how="inner")
            .map_blocks(lambda campaign_id: {
                "n": (campaign_id >= 0).to(torch.float64)})
            .select(keep)
            .group_by("campaign_id")
            .aggregate(fetches, window=stream.tumbling(10.0),
                       time_col="event_time", watermark_delay=1.0))


def ysb_check(np, frames, counts) -> int:
    """Every emitted (window, campaign) count equals numpy's exactly and
    every window emits once; returns the windows checked."""
    n_windows, n_campaigns = counts.shape
    assert len(frames) == n_windows, (len(frames), n_windows)
    seen = set()
    for f in frames:
        cols = f.blocks()[0].columns
        w = int(cols["window_start"][0] // 10.0)
        assert w not in seen, f"window {w} emitted twice"
        seen.add(w)
        assert np.array_equal(cols["campaign_id"], np.arange(n_campaigns))
        assert np.array_equal(cols["n"], counts[w].astype(np.float64)), \
            f"window {w}: counts differ from numpy"
    return len(seen)


STREAM_COUNTERS = ("stream.batches", "stream.batches_skipped",
                   "stream.late_rows", "stream.windows_emitted",
                   "stream.merge_compiles", "stream.state_spills",
                   "stream.state_faults", "stream.state_evictions",
                   "retry.stream.batch.retries", "stream.slot_waits")


def stream_counts() -> dict:
    from tensorframes_tpu_torch.utils.tracing import counters
    return {k: counters.get(k) for k in STREAM_COUNTERS}


def count_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in stream_counts().items()}


def phase_stream_ysb(ttf, np, torch, segment_reduce, n=20_000_000,
                     batch=400_000, rate=100_000, seed=21) -> dict:
    """The Yahoo Streaming Benchmark's query as a stream (see the module
    docstring, phase 3f)."""
    import threading

    from tensorframes_tpu_torch import stream
    from tensorframes_tpu_torch.engine import pipeline
    from tensorframes_tpu_torch.observability import metrics
    from tensorframes_tpu_torch.resilience import faults
    from tensorframes_tpu_torch.utils.tracing import counters

    t0 = time.perf_counter()
    batches, late_b, table = ysb_events(np, n, batch, rate, seed=seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = ysb_reference(np, batches, table)
    reference_s = time.perf_counter() - t0
    counts = ref["counts"]
    late_views = int(np.sum(late_b["event_type"] == YSB_VIEW))
    # the folds: one per batch and 10 s window its span touches
    predicted = sum(len(np.unique(np.floor(
        b["event_time"][[0, -1]] / 10.0))) for b in batches)
    schema = ttf.frame(dict(batches[0])).schema
    out = {"events": n, "batch_events": batch, "batches": len(batches),
           "windows": counts.shape[0], "campaigns": counts.shape[1],
           "late_events": len(late_b["user_id"]), "late_views": late_views,
           "predicted_launches": predicted, "gen_s": gen_s,
           "reference_s": reference_s,
           "note": "part b's distinct users are not in the benchmark's "
                   "published query"}

    def source(extra=()):
        return stream.GeneratorSource(
            iter([dict(b) for b in batches] + [dict(e) for e in extra]))

    # (a) the query, then a late batch for the first window
    c0, l0 = stream_counts(), segment_reduce.launches
    t0 = time.perf_counter()
    h = ysb_query(ttf, torch, source([late_b]), table).start(name="ysb-a")
    h.run()
    wall = time.perf_counter() - t0
    ysb_check(np, h.collect_updates(), counts)
    c = count_delta(c0)
    assert c["stream.batches_skipped"] == 0, c
    assert c["stream.late_rows"] == late_views, c
    assert c["stream.windows_emitted"] == counts.shape[0], c
    launches = segment_reduce.launches - l0
    assert launches == predicted, (launches, predicted)
    out["a_query"] = {"wall_s": wall, "launches": launches, "counters": c,
                      "events_per_s": (n + late_b["user_id"].size) / wall}

    # (b) with distinct users: the live windows' HLL registers after
    # `mid` batches against the CPU executor's fold of the same rows,
    # then every estimate against numpy's exact count
    probe = ttf.relational.approx_distinct()
    l0 = segment_reduce.launches
    t0 = time.perf_counter()
    agg = ysb_query(ttf, torch, source(), table, distinct=True)
    h = agg.start(name="ysb-b")
    mid = min(10, len(batches) - 1)
    for _ in range(mid):
        assert h.step()
    seen_views = sum(int(np.sum(b["event_type"] == YSB_VIEW))
                     for b in batches[:mid])
    w_mid, c_mid, u_mid = (ref[k][:seen_views] for k in ("w", "c", "u"))
    checked = 0
    for s, st in list(agg._windows.items()):
        regs = st.values["user_id"]
        assert regs.device.type == ttf.default_device().type, regs.device
        m = w_mid == int(s // 10.0)
        keys = st.keys_u[0]
        cpu = probe.block_partial(u_mid[m], np.searchsorted(keys, c_mid[m]),
                                  len(keys), device=torch.device("cpu"))
        assert np.array_equal(regs.cpu().numpy(), cpu), \
            f"window {s}: registers differ from the CPU executor's fold"
        checked += 1
    assert checked >= 1
    h.run()
    wall = time.perf_counter() - t0
    frames = h.collect_updates()
    assert len(frames) == counts.shape[0]
    worst = 0.0
    for f in frames:
        cols = f.blocks()[0].columns
        w = int(cols["window_start"][0] // 10.0)
        assert np.array_equal(cols["n"], counts[w].astype(np.float64))
        exact = ref["distinct"][w][cols["campaign_id"]]
        dev = np.abs(cols["user_id"] - exact) / (probe.relative_error
                                                 * exact)
        worst = max(worst, float(dev.max()))
        assert dev.max() <= 5.0, (w, float(dev.max()))
    out["b_distinct_users"] = {
        "wall_s": wall, "launches": segment_reduce.launches - l0,
        "windows_registers_checked": checked, "worst_sigma": worst,
        "hll_bits": probe.bits}

    # (c) one transient batch fault (retried, never counted twice) and one
    # drifted batch through a QueueSource: event_type arrives as per-row
    # cells, which pass the producer's column check and poison the batch
    # at its forcing (skipped and counted); the drifted batch is an extra
    # copy of a batch, so the counts stay numpy's
    c0, l0 = stream_counts(), segment_reduce.launches
    src = stream.QueueSource(schema, maxsize=len(batches) + 1)
    for i, b in enumerate(batches):
        src.put(dict(b))
        if i == min(7, len(batches) - 1):
            bad = dict(b)
            bad["event_type"] = [np.array(v) for v in b["event_type"]]
            src.put(bad)
    src.close()
    t0 = time.perf_counter()
    h = ysb_query(ttf, torch, src, table).start(name="ysb-c")
    h.run(max_batches=5)
    with faults.inject("batch", fail_n=1):  # transient: retried
        h.run()
    wall = time.perf_counter() - t0
    c = count_delta(c0)
    assert c["stream.batches_skipped"] == 1, c
    assert c["retry.stream.batch.retries"] == 1, c
    ysb_check(np, h.collect_updates(), counts)
    launches = segment_reduce.launches - l0
    assert launches == predicted, (launches, predicted)
    out["c_failure_isolation"] = {"wall_s": wall, "launches": launches,
                                  "counters": c}

    # (d) the background pump: a producer thread feeds a bounded queue,
    # a slot pool is installed and the windows go to a parquet sink
    c0, l0 = stream_counts(), segment_reduce.launches
    v0 = counters.get("invariants.violations")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "data")
    os.makedirs(root, exist_ok=True)
    sink_path = os.path.join(root, "ysb_windows.parquet")
    if os.path.exists(sink_path):
        os.remove(sink_path)
    src = stream.QueueSource(schema, maxsize=4)
    pool = pipeline.SlotPool(2)
    prev = pipeline.install_slot_pool(pool)
    try:
        t0 = time.perf_counter()
        h = ysb_query(ttf, torch, src, table).start(
            name="ysb", sink=stream.ParquetSink(sink_path))
        h.start_background(poll_interval=0.001)

        def produce():
            for b in batches:
                src.put(dict(b))  # waits while the queue is full
            src.close()

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        give_up = time.monotonic() + 600
        while not h.done() and time.monotonic() < give_up:
            time.sleep(0.005)
        producer.join(timeout=60)
        wall = time.perf_counter() - t0
        assert h.done() and h.error is None, h.error
        text = metrics.metrics_text()
        h.stop()
    finally:
        pipeline.install_slot_pool(prev)
    assert pool.leased() == 0, pool.leased()
    assert counters.get("invariants.violations") == v0
    assert f'tft_stream_batches_total{{stream="ysb"}} {len(batches)}' \
        in text
    frames = h.collect_updates()
    ysb_check(np, frames, counts)
    back = ttf.read_parquet(sink_path)
    assert back.count() == counts.size
    for col in ("window_start", "campaign_id", "n"):
        got = np.concatenate([b.columns[col] for b in back.blocks()])
        want = np.concatenate([f.blocks()[0].columns[col] for f in frames])
        assert np.array_equal(got, want), f"the sink's {col} differs"
    c = count_delta(c0)
    assert c["stream.batches_skipped"] == 0, c
    launches = segment_reduce.launches - l0
    assert launches == predicted, (launches, predicted)
    out["d_background_pump"] = {"wall_s": wall, "launches": launches,
                                "counters": c,
                                "sink_row_groups": back.num_partitions}
    return out


def tail_file(np, src_path, groups, repeat) -> tuple:
    """``src_path``'s ``ts``, ``key``, ``x`` and ``y`` row groups, then
    group ``repeat`` once more (the appended group), written under
    ``build/data/`` unless there already; returns the path and the
    seconds spent writing."""
    import pyarrow.parquet as pq

    path = src_path.replace(".parquet", f"_tail{repeat}.parquet")
    if os.path.exists(path) and \
            pq.read_metadata(path).num_row_groups == groups + 1:
        return path, 0.0
    t0 = time.perf_counter()
    tmp = path + ".tmp"
    writer = None
    with pq.ParquetFile(src_path) as pf:
        for g in list(range(groups)) + [repeat]:
            tbl = pf.read_row_group(g, columns=["ts", "key", "x", "y"])
            if writer is None:
                writer = pq.ParquetWriter(tmp, tbl.schema)
            writer.write_table(tbl, row_group_size=tbl.num_rows)
    writer.close()
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def window_reference(np, ts, key, x, y, starts, size, keys) -> dict:
    """numpy's per-window ``x`` sums (f64 bincount) and ``y`` maxima over
    the rows with ``start <= ts < start + size``."""
    out = {}
    for s in starts:
        m = (ts >= s) & (ts < s + size)
        k = key[m]
        present = np.bincount(k, minlength=keys) > 0
        sums = np.bincount(k, weights=x[m], minlength=keys)
        mx = np.full(keys, -np.inf)
        np.maximum.at(mx, k, y[m])
        out[float(s)] = (np.flatnonzero(present), sums[present],
                         mx[present])
    return out


def check_windows(np, frames, want) -> int:
    """Emitted windows against :func:`window_reference`: keys in order,
    ``x`` sums to rtol 1e-12, ``y`` maxima exactly, every window once."""
    seen = []
    for f in frames:
        cols = f.blocks()[0].columns
        s = float(cols["window_start"][0])
        keys, sums, mx = want[s]
        assert np.array_equal(cols["key"], keys), f"window {s}: keys"
        np.testing.assert_allclose(cols["x"], sums, rtol=1e-12, atol=0,
                                   err_msg=f"window {s}: x sums")
        assert np.array_equal(cols["y"], mx), f"window {s}: y maxima"
        seen.append(s)
    assert sorted(seen) == sorted(want), (sorted(seen), sorted(want))
    return len(seen)


def phase_stream_windows_parquet(ttf, np, torch, segment_reduce,
                                 n=20_000_000, groups=20, keys=100_000,
                                 seed=11) -> dict:
    """Keyed sliding windows over the plan phase's parquet file, tailed a
    row group a poll (see the module docstring, phase 3g)."""
    import pyarrow.parquet as pq

    from tensorframes_tpu_torch import stream

    path, write_s = scan_file(np, n, groups, keys, seed)
    cols = ["ts", "key", "x", "y"]
    per = n // groups
    size, slide = 4 * per, 2 * per
    tbl = pq.read_table(path, columns=cols)
    ts, key, x, y = (tbl.column(c).to_numpy() for c in cols)
    del tbl
    starts = np.arange(-slide, n, slide)
    t0 = time.perf_counter()
    want = window_reference(np, ts, key, x, y, starts, size, keys)
    reference_s = time.perf_counter() - t0
    out = {"rows": n, "row_groups": groups, "keys": keys,
           "window": {"size": size, "slide": slide},
           "windows": int(starts.size), "write_s": write_s,
           "reference_s": reference_s}

    def query(src_path, **kw):
        return (stream.from_source(stream.ParquetTailSource(
                    src_path, columns=cols, follow=False))
                .group_by("key")
                .aggregate({"x": "sum", "y": "max"},
                           window=stream.sliding(size, slide),
                           time_col="ts", **kw))

    def drive(h):
        peak = during = 0
        while not h.done():
            if h.step():
                peak = max(peak, h.metrics()["state_rows"])
                during = h.metrics()["windows_emitted"]
        return peak, during

    # (a) the query: each row group folds into two windows
    c0, l0 = stream_counts(), segment_reduce.launches
    t0 = time.perf_counter()
    h = query(path).start(name="windows-a")
    peak, during = drive(h)
    wall = time.perf_counter() - t0
    checked = check_windows(np, h.collect_updates(), want)
    c = count_delta(c0)
    launches = segment_reduce.launches - l0
    assert launches == 2 * groups, launches
    assert c["stream.windows_emitted"] == starts.size, c
    assert c["stream.batches_skipped"] == 0, c
    out["a_query"] = {"wall_s": wall, "launches": launches,
                      "emitted_during_stream": during,
                      "emitted_at_finalize": checked - during,
                      "peak_state_rows": peak, "counters": c,
                      "rows_per_s": n / wall}

    # (b) under a ledger and a state cap, the watermark held back a
    # window, and row group `repeat` appended again after the last
    repeat = (3 * groups) // 4
    tpath, tail_s = tail_file(np, path, groups, repeat)
    rep = slice(repeat * per, (repeat + 1) * per)
    want_b = window_reference(
        np, *(np.concatenate([a, a[rep]]) for a in (ts, key, x, y)),
        starts, size, keys)
    cap = (5 * keys) // 2
    c0, l0 = stream_counts(), segment_reduce.launches
    ttf.memory.configure(limit_bytes=2 << 30)
    try:
        t0 = time.perf_counter()
        h = query(tpath, watermark_delay=size,
                  max_state_rows=cap).start(name="windows-b")
        peak_b, _ = drive(h)
        wall = time.perf_counter() - t0
        checked_b = check_windows(np, h.collect_updates(), want_b)
    finally:
        ttf.memory._reset()
    c = count_delta(c0)
    assert c["stream.state_spills"] >= 1, c
    assert c["stream.state_evictions"] == 0, c
    assert c["stream.state_faults"] >= 1, c
    out["b_budget"] = {"wall_s": wall, "max_state_rows": cap,
                       "repeated_group": repeat, "tail_write_s": tail_s,
                       "launches": segment_reduce.launches - l0,
                       "windows_checked": checked_b,
                       "peak_state_rows": peak_b, "counters": c}

    # (c) the first 4 row groups through a row-local chain, bit-equal to
    # the batch path over the same groups
    def chain(sf):
        return (sf.map_rows(lambda x, y: {"z": x * y + 1.0})
                  .filter(lambda z: z > 1.25)
                  .select(["ts", "key", "z"]))

    h = chain(stream.from_source(stream.ParquetTailSource(
        path, columns=cols, follow=False))).start(name="windows-c")
    assert h.run(max_batches=4) == 4
    got = h.collect_updates()
    h.stop()
    batch = chain(ttf.read_parquet(path, columns=cols,
                                   row_group_limit=4)).blocks()
    assert len(got) == len(batch) == 4
    for g, b in zip(got, batch):
        for col in ("ts", "key", "z"):
            assert np.array_equal(g.blocks()[0].columns[col],
                                  b.columns[col]), col
    out["c_finite_equivalence"] = {
        "row_groups": 4, "rows_out": int(sum(b.num_rows for b in batch))}
    return out


SHIPPED_DATA = r'''
def shipped_tables(np, n, keys, jl_rows, feats, jl_keys, agg_rows,
                   agg_keys):
    """The shipped-computation phase's data from numpy seeds: the
    reference workload (phase 2's ``key``/``x``, seed 2), the JL rows
    (``x`` [jl_rows, feats] f32 N(0, 1), ``key`` in [0, jl_keys), seed 12)
    and the computation-form aggregate's rows (``key`` in [0, agg_keys),
    ``v`` in [0, 1), seed 13)."""
    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    rng = np.random.default_rng(12)
    jx = rng.standard_normal((jl_rows, feats), dtype=np.float32)
    jkey = rng.integers(0, jl_keys, jl_rows)
    rng = np.random.default_rng(13)
    akey = rng.integers(0, agg_keys, agg_rows)
    av = rng.random(agg_rows)
    return {"ref": {"key": key, "x": x}, "jl": {"key": jkey, "x": jx},
            "agg": {"key": akey, "v": av}}


def column(np, frame, name):
    return np.concatenate([b.columns[name] for b in frame.blocks()])


def digest(np, a):
    """sha256 of an array's dtype, shape and bytes."""
    import hashlib

    a = np.ascontiguousarray(a)
    h = hashlib.sha256(repr((str(a.dtype), a.shape)).encode())
    h.update(a.view(np.uint8).tobytes() if a.size else b"")
    return h.hexdigest()


def run_shipped(ttf, np, builder, tables, parts, graphs):
    """P1-P4 through the builder over ``tables``, one builder call each:
    ``graphs[name](b)`` attaches the program to builder ``b`` (``.graph``
    of its bytes in the child, ``.computation`` of the live program in the
    parent). Returns (digests, walls, results)."""
    import time

    walls, out = {}, {}
    t0 = time.perf_counter()
    df = ttf.frame(tables["ref"], num_partitions=parts)
    zf = graphs["p1"](builder.map_blocks_builder(df)).build().cache()
    out["map_z"] = column(np, zf, "z")
    walls["p1_map_blocks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg = ttf.aggregate({"z": "sum"},
                        zf.select(["key", "z"]).group_by("key"))
    cols = agg.blocks()[0].columns
    out["agg_key"], out["agg_z"] = cols["key"], cols["z"]
    walls["p1_aggregate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = graphs["p3"](builder.reduce_blocks_builder(
        zf.select(["z"]))).build()
    out["reduce_z"] = np.asarray(total["z"])
    walls["p3_reduce_blocks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jdf = ttf.frame(tables["jl"], num_partitions=parts)
    jf = graphs["p2"](builder.map_rows_builder(jdf)).build().cache()
    out["jl_z"] = column(np, jf, "z")
    walls["p2_map_rows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jagg = ttf.aggregate({"z": "sum"},
                         jf.select(["key", "z"]).group_by("key"))
    cols = jagg.blocks()[0].columns
    out["jl_agg_key"], out["jl_agg_z"] = cols["key"], cols["z"]
    walls["p2_aggregate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adf = ttf.frame(tables["agg"], num_partitions=parts)
    pagg = graphs["p4"](builder.aggregate_builder(
        adf.group_by("key"))).build()
    cols = pagg.blocks()[0].columns
    out["p4_key"], out["p4_v"] = cols["key"], cols["v"]
    walls["p4_aggregate_s"] = time.perf_counter() - t0
    return {k: digest(np, v) for k, v in out.items()}, walls, out
'''

SHIPPED_CHILD = SHIPPED_DATA + r'''
import json
import sys
import time

t_start = time.perf_counter()
import numpy as np
import torch

import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import builder, serve
from tensorframes_tpu_torch.engine.executor import (BlockExecutor,
                                                    set_computation_interner)
from tensorframes_tpu_torch.ops import segment_reduce
from tensorframes_tpu_torch.utils.tracing import counters

args = json.loads(sys.argv[1])
device = args["device"]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ttf.set_default_device(device)
if device == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
report = {"start_s": time.perf_counter() - t_start}
t0 = time.perf_counter()
tables = shipped_tables(np, **args["sizes"])
report["data_s"] = time.perf_counter() - t0


def blob(name):
    with open(args["paths"][name], "rb") as f:
        return f.read()


# the first deserialization and placement pay torch.export's imports
t0 = time.perf_counter()
ttf.Computation.deserialize(blob("p1")).fn.place(device)
report["first_load_s"] = time.perf_counter() - t0

# (b) the programs, from their files, through the builder
segment_reduce.launches = 0
t0 = time.perf_counter()
digests, walls, _ = run_shipped(
    ttf, np, builder, tables, args["partitions"],
    {k: (lambda b, k=k: b.graph(blob(k))) for k in args["paths"]})
report.update(digests=digests, walls=walls,
              path_s=time.perf_counter() - t0,
              launches=segment_reduce.launches,
              fold_calls=counters.get("aggregate.fold_calls"))

# (c) two loads of P1 under the interner prepare one device program;
# uninstalled, a third load prepares anew
ex = BlockExecutor(device)
cache = serve.SharedCompileCache()
small = ttf.frame({"x": tables["ref"]["x"][:1_000_000]}, num_partitions=2)
prev = set_computation_interner(cache.intern)
try:
    runs = [column(np, ttf.map_blocks(builder.load_computation(
        args["paths"]["p1"]), small, executor=ex), "z") for _ in range(2)]
finally:
    set_computation_interner(prev)
interned = dict(cache.stats(), compile_count=ex.compile_count)
runs.append(column(np, ttf.map_blocks(builder.load_computation(
    args["paths"]["p1"]), small, executor=ex), "z"))
assert all(np.array_equal(r, 2 * tables["ref"]["x"][:1_000_000])
           for r in runs), "the interned runs disagree"
interned["compile_count_after_uninstall"] = ex.compile_count
report["interner"] = interned

# (d) a program serialized with the default device the card's runs on
# the CPU executor and on the card, equal
neutral = ttf.Computation.trace(
    lambda x: {"z": x * 2.0 + torch.arange(x.shape[0], device=x.device,
                                           dtype=x.dtype)},
    [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1))])
shipped = ttf.Computation.deserialize(neutral.serialize())
xs = tables["ref"]["x"][:100_000]
on_cpu = BlockExecutor("cpu").run(shipped, {"x": xs})["z"]
on_card = BlockExecutor(device).run(shipped, {"x": xs})["z"]
report["neutral"] = {
    "rows": int(xs.size), "equal": bool(np.array_equal(on_cpu, on_card)),
    "exact": bool(np.array_equal(on_card, xs * 2.0 + np.arange(xs.size)))}

report["foreign_modules"] = sorted(
    m for m in sys.modules if m in ("jax", "tensorframes_tpu")
    or m.startswith(("jax.", "tensorframes_tpu.")))
report["wall_s"] = time.perf_counter() - t_start
print(json.dumps(report), flush=True)
'''

_shipped_ns: dict = {}
exec(SHIPPED_DATA, _shipped_ns)
shipped_tables = _shipped_ns["shipped_tables"]
run_shipped = _shipped_ns["run_shipped"]
digest = _shipped_ns["digest"]


def phase_shipped_computation(ttf, np, torch, segment_reduce, n=20_000_000,
                              parts=8, keys=100_000, jl_rows=2_000_000,
                              feats=64, proj=16, jl_keys=100_000,
                              agg_rows=2_000_000, agg_keys=1_024,
                              device="cuda", out=None) -> dict:
    """Shipped computations (see the module docstring, phase 3h): P1-P4
    serialized here with ``save_computation`` into ``build/data/shipped/``
    and run from their files in a fresh process through the builder, then
    run here as live programs on the same data. ``out["child_launches"]``
    receives the child's segment_sum launches, which this process's
    counter cannot see. ``device="cpu"`` rehearses the phase on the CPU,
    where no kernel launches and none is counted."""
    from tensorframes_tpu_torch import builder, dsl
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.engine import ops as engine_ops
    from tensorframes_tpu_torch.shape import Shape, Unknown
    from tensorframes_tpu_torch.utils.tracing import counters

    root = os.path.dirname(os.path.abspath(__file__))
    ship_dir = os.path.join(root, "build", "data", "shipped")
    os.makedirs(ship_dir, exist_ok=True)
    sizes = {"n": n, "keys": keys, "jl_rows": jl_rows, "feats": feats,
             "jl_keys": jl_keys, "agg_rows": agg_rows, "agg_keys": agg_keys}
    t0 = time.perf_counter()
    tables = shipped_tables(np, **sizes)
    data_s = time.perf_counter() - t0

    # (a) the programs: P1 the reference workload's map in the DSL, P2
    # the JL row program closing over P (on the CPU: a lifted constant),
    # P3 the reduce_blocks sum, P4 the computation-form aggregate's sum
    double, f32 = ttf.dtypes.double, ttf.dtypes.float32
    with dsl.with_graph():
        x = dsl.placeholder(double, Shape(Unknown), name="x")
        p1 = engine_ops.cached_map_computation(
            dsl.add(x, x, name="z"),
            ttf.frame({"x": tables["ref"]["x"][:1]}).schema, True)
    proj_np = (np.random.default_rng(14).standard_normal((feats, proj))
               / np.sqrt(proj)).astype(np.float32)
    P = torch.from_numpy(proj_np)

    def jl_program(table):
        return Computation.trace(lambda x: {"z": ((x @ table) ** 2).sum(-1)},
                                 [TensorSpec("x", f32, Shape(feats))])

    live = {"p1": p1, "p2": jl_program(P),
            "p3": Computation.trace(
                lambda z_input: {"z": torch.sum(z_input, 0)},
                [TensorSpec("z_input", double, Shape(Unknown))]),
            "p4": Computation.trace(
                lambda v_input: {"v": torch.sum(v_input, 0)},
                [TensorSpec("v_input", double, Shape(Unknown))])}
    paths, blob_bytes = {}, {}
    t0 = time.perf_counter()
    for name, comp in live.items():
        paths[name] = os.path.join(ship_dir, f"{name}.tftc")
        builder.save_computation(comp, paths[name])
        blob_bytes[name] = os.path.getsize(paths[name])
    serialize_s = time.perf_counter() - t0
    # the live twin of P2 runs here with its table on the device
    live["p2"] = jl_program(P.to(device))

    # (b)-(d) the child: a fresh interpreter that sees only the files
    arg = json.dumps({"device": device, "sizes": sizes, "paths": paths,
                      "partitions": parts})
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SHIPPED_CHILD, arg],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    child_s = time.perf_counter() - t0
    if res.stderr:
        sys.stderr.write(res.stderr[-4000:])
    assert res.returncode == 0, \
        f"the shipped-program process failed ({res.returncode})"
    child = json.loads(res.stdout.strip().splitlines()[-1])
    if out is not None:
        out["child_launches"] = child["launches"]

    # the same programs live, on the same data, through the same builders
    before = segment_reduce.launches
    folds0 = counters.get("aggregate.fold_calls")
    t0 = time.perf_counter()
    digests, walls, cols = run_shipped(
        ttf, np, builder, tables, parts,
        {k: (lambda b, k=k: b.computation(live[k])) for k in live})
    live_s = time.perf_counter() - t0
    live_launches = segment_reduce.launches - before
    live_folds = counters.get("aggregate.fold_calls") - folds0
    # P4 is the one computation-form aggregate: it folds in both
    assert child["fold_calls"] > 0 and live_folds > 0, \
        (child["fold_calls"], live_folds)
    differ = sorted(k for k in digests if digests[k] != child["digests"][k])
    assert not differ, f"the shipped programs differ from the live: {differ}"

    ref, jl, agg = tables["ref"], tables["jl"], tables["agg"]
    assert np.array_equal(cols["map_z"], 2 * ref["x"]), "z = x + x not exact"
    want = np.bincount(ref["key"], weights=2 * ref["x"], minlength=keys)
    np.testing.assert_array_equal(cols["agg_key"], np.arange(keys))
    np.testing.assert_allclose(cols["agg_z"], want, rtol=1e-12)
    np.testing.assert_allclose(cols["reduce_z"], np.sum(2 * ref["x"]),
                               rtol=1e-12)
    z = cols["jl_z"]
    assert z.dtype == np.float32 and z.shape == (jl_rows,)
    idx = np.random.default_rng(71).choice(jl_rows, 10_000, replace=False)
    want_z = ((jl["x"][idx].astype(np.float64)
               @ proj_np.astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(z[idx], want_z, rtol=1e-4, atol=1e-4)
    want = np.bincount(jl["key"], weights=z.astype(np.float64),
                       minlength=jl_keys)
    scale = np.bincount(jl["key"], weights=np.abs(z.astype(np.float64)),
                        minlength=jl_keys)
    np.testing.assert_array_equal(cols["jl_agg_key"], np.arange(jl_keys))
    err = np.abs(cols["jl_agg_z"].astype(np.float64) - want)
    assert (err <= 1e-5 * scale).all(), float(np.max(err / scale))
    want = np.bincount(agg["key"], weights=agg["v"], minlength=agg_keys)
    np.testing.assert_array_equal(cols["p4_key"], np.arange(agg_keys))
    np.testing.assert_allclose(cols["p4_v"], want, rtol=1e-12)

    predicted = 2 * parts if device == "cuda" else 0
    assert child["launches"] == predicted, child["launches"]
    assert live_launches == predicted, live_launches
    assert child["interner"]["hits"] == 1, child["interner"]
    assert child["interner"]["misses"] == 1, child["interner"]
    assert child["interner"]["compile_count"] == 1, child["interner"]
    assert child["interner"]["compile_count_after_uninstall"] == 2, \
        child["interner"]
    assert child["neutral"]["equal"] and child["neutral"]["exact"], \
        child["neutral"]
    assert not child["foreign_modules"], child["foreign_modules"]
    return {"rows": n, "partitions": parts, "keys": keys,
            "jl": {"rows": jl_rows, "features": feats, "keys": jl_keys},
            "aggregate_form": {"rows": agg_rows, "keys": agg_keys},
            "blob_bytes": blob_bytes, "data_s": data_s,
            "serialize_s": serialize_s, "child_s": child_s,
            "child": {k: child[k] for k in (
                "start_s", "data_s", "first_load_s", "path_s", "walls",
                "launches", "fold_calls",
                "interner", "neutral", "wall_s")},
            "live": {"wall_s": live_s, "walls": walls,
                     "launches": live_launches, "fold_calls": live_folds},
            "p4_wall_before_fold_s": 14.3,
            "digests_equal": len(digests),
            "jl_max_rel_err": float(np.max(err / scale))}


def phase_aggregate_fold(ttf, np, torch, n=20_000_000, parts=8,
                         keys=1_024, p4_rows=2_000_000, seed=31) -> dict:
    """The computation form of ``aggregate`` through the segmented fold
    (see the module docstring, phase 3i)."""
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(seed)
    key = rng.integers(0, keys, n)
    v = rng.random(n)  # positive: rtol 1e-12 without cancellation
    df = ttf.frame({"key": key, "v": v}, num_partitions=parts)
    programs = {
        "sum": (lambda v_input: {"v": v_input.sum(0)},
                np.bincount(key, weights=v, minlength=keys)),
        "norm": (lambda v_input: {"v": torch.sqrt((v_input ** 2).sum(0))},
                 np.sqrt(np.bincount(key, weights=v * v, minlength=keys)))}
    out = {"rows": n, "partitions": parts, "keys": keys}
    for name, (fn, want) in programs.items():
        c0 = counters.get("aggregate.fold_calls")
        b0 = counters.get("aggregate.buffer_calls")
        t0 = time.perf_counter()
        cols = ttf.aggregate(fn, df.group_by("key")).blocks()[0].columns
        wall = time.perf_counter() - t0
        assert counters.get("aggregate.buffer_calls") == b0
        np.testing.assert_array_equal(cols["key"], np.arange(keys))
        assert cols["v"].dtype == np.float64
        np.testing.assert_allclose(cols["v"], want, rtol=1e-12)
        out[name] = {"wall_s": wall,
                     "fold_calls": counters.get("aggregate.fold_calls") - c0,
                     "max_rel_err": float(np.max(np.abs(cols["v"] - want)
                                                 / want))}
    del df, key, v

    # P4's shape: 2M rows into 1,024 keys, through the fold and through
    # the CompactionBuffer path of an executor of another kind
    rng = np.random.default_rng(13)
    akey = rng.integers(0, keys, p4_rows)
    av = rng.random(p4_rows)
    adf = ttf.frame({"key": akey, "v": av}, num_partitions=parts)
    want = np.bincount(akey, weights=av, minlength=keys)
    class BufferPathExecutor(BlockExecutor):
        """An executor of another kind than the default: the selection
        rule keeps the computation form on the CompactionBuffer path."""

    for name, ex in (("p4_fold", None),
                     ("p4_buffer", BufferPathExecutor())):
        c0 = counters.get("aggregate.fold_calls")
        b0 = counters.get("aggregate.buffer_calls")
        t0 = time.perf_counter()
        cols = ttf.aggregate(lambda v_input: {"v": torch.sum(v_input, 0)},
                             adf.group_by("key"),
                             executor=ex).blocks()[0].columns
        wall = time.perf_counter() - t0
        np.testing.assert_array_equal(cols["key"], np.arange(keys))
        np.testing.assert_allclose(cols["v"], want, rtol=1e-12)
        folds = counters.get("aggregate.fold_calls") - c0
        reduces = counters.get("aggregate.buffer_calls") - b0
        assert (folds > 0, reduces > 0) == \
            ((True, False) if ex is None else (False, True)), (folds, reduces)
        out[name] = {"rows": p4_rows, "wall_s": wall, "fold_calls": folds,
                     "buffer_reduce_calls": reduces}
    return out


def kmeans_numpy_step(np, pts, centers, chunk=250_000) -> tuple:
    """One k-means step in numpy f64 by the matrix form of the distances
    (``|x|^2 + |c|^2 - 2 x.c``), a chunk of rows at a time: the new
    centers (an empty cluster keeps its center) and the total distance."""
    k, m = centers.shape
    csq = (centers * centers).sum(1)
    sums = np.zeros((k, m))
    counts = np.zeros(k)
    total = 0.0
    for lo in range(0, len(pts), chunk):
        x = pts[lo:lo + chunk]
        d = (x * x).sum(1)[:, None] + csq[None, :] - 2.0 * (x @ centers.T)
        idx = d.argmin(1)
        total += float(d[np.arange(len(x)), idx].sum())
        counts += np.bincount(idx, minlength=k)
        for c in range(m):
            sums[:, c] += np.bincount(idx, weights=x[:, c], minlength=k)
    new = np.where(counts[:, None] > 0,
                   sums / np.maximum(counts, 1.0)[:, None], centers)
    return new, total


def phase_kmeans_demo(ttf, np, torch, segment_reduce, n=2_000_000, m=64,
                      k=256, parts=8, steps=3, seed=1) -> dict:
    """The ported demos on the card (see the module docstring, phase
    3j)."""
    from tensorframes_tpu_torch.demos import geom_mean, groupby_scratch
    from tensorframes_tpu_torch.demos import kmeans

    t0 = time.perf_counter()
    df, init, _ = kmeans.make_data(n=n, num_features=m, k=k,
                                   num_partitions=parts, seed=seed)
    pts = np.concatenate([b.dense("features") for b in df.blocks()])
    out = {"rows": n, "features": m, "k": k, "partitions": parts,
           "steps": steps, "data_s": time.perf_counter() - t0}
    # numpy's trajectory from the initial centers: every variant's step i
    # takes its input centers and is held to its next centers and distance
    inputs, wants, ref_walls = [], [], []
    c = np.asarray(init, np.float64)
    for _ in range(steps):
        t0 = time.perf_counter()
        want = kmeans_numpy_step(np, pts, c)
        ref_walls.append(time.perf_counter() - t0)
        inputs.append(c)
        wants.append(want)
        c = want[0]
    out["numpy_step_walls_s"] = ref_walls
    del pts

    from tensorframes_tpu_torch import parallel
    t0 = time.perf_counter()
    dist = parallel.distribute(df, parallel.local_mesh())
    out["distribute_s"] = time.perf_counter() - t0
    shards = dist.mesh.num_data_shards
    # launches a step: variant B two segment_sum calls a block, C two on
    # the gathered array, D one a sum column (3) and shard; A none
    for variant, frame, per_step in (
            ("aggregate", df, 0), ("preaggregate", df, 2 * parts),
            ("device_resident", dist, 2), ("daggregate", dist, 3 * shards)):
        step = getattr(kmeans, f"step_{variant}")
        walls, errs = [], []
        l0 = segment_reduce.launches
        for c, (want_c, want_d) in zip(inputs, wants):
            t0 = time.perf_counter()
            got_c, got_d = step(frame, c)
            walls.append(time.perf_counter() - t0)
            # f64 sums in other orders, the distances from another GEMM
            np.testing.assert_allclose(got_c, want_c, rtol=1e-9, atol=1e-9)
            assert abs(got_d - want_d) <= 1e-9 * abs(want_d), (got_d, want_d)
            errs.append(float(np.max(np.abs(got_c - want_c))))
        launches = segment_reduce.launches - l0
        assert launches == per_step * steps, (variant, launches)
        out[variant] = {"step_walls_s": walls, "launches": launches,
                        "max_abs_center_err": max(errs),
                        "final_distance": got_d}
    out["mesh_shards"] = shards
    del df, dist

    # geom_mean and groupby_scratch at their demo sizes, held to the
    # numpy checks of the JAX package's demo tests
    t0 = time.perf_counter()
    gdf = geom_mean.make_data(n=30)
    x = np.concatenate([b.dense("x") for b in gdf.blocks()])
    keys = np.concatenate([np.asarray(list(b.columns["key"]))
                           for b in gdf.blocks()])
    for mean in ("harmonic", "geometric"):
        rows = getattr(geom_mean, f"{mean}_mean_per_key")(gdf).collect()
        got = {r["key"]: r[f"{mean}_mean"] for r in rows}
        assert set(got) == {"g0", "g1", "g2"}, got
        for g, val in got.items():
            grp = x[keys == g]
            want = (len(grp) / (1.0 / grp).sum() if mean == "harmonic"
                    else np.exp(np.log(grp).mean()))
            assert abs(val - want) <= 1e-6 * want, (mean, g, val, want)
    rows = groupby_scratch.groupby_sum()
    assert [(r["key"], r["x"]) for r in rows] == [("0", 3.0), ("1", 12.0)]
    assert [r["z"] for r in groupby_scratch.readme_map_blocks()] == \
        [3.0, 4.0, 5.0, 6.0, 7.0]
    s, mn = groupby_scratch.readme_reduce_vector()
    np.testing.assert_allclose(s, [3.0, 3.0])
    np.testing.assert_allclose(mn, [1.0, 1.0])
    np.testing.assert_allclose(
        [r["z"] for r in groupby_scratch.readme_dsl_map()],
        np.arange(5.0) * 0.1 + 3.0)
    out["small_demos_s"] = time.perf_counter() - t0
    return out


def env_scope(**knobs):
    """Environment knobs set for the length of a ``with`` block."""
    from unittest import mock
    return mock.patch.dict(os.environ, knobs)


ADAPTIVE_COUNTERS = ("plan.adaptive_layouts", "plan.adaptive_coalesces",
                     "plan.adaptive_splits", "plan.replans",
                     "plan.filter_reorders", "plan.result_cache_hits")


def default_forcings(np, force) -> dict:
    """``force()`` (a phase's query: a list of blocks) once with the
    adaptive layout and the result cache off, then twice with both at
    their default (on), inside a phase that :func:`static_plan` runs with
    both off: each default result's :func:`digest_blocks` equal to the
    static one's. The static runs before have recorded the plan shape's
    feedback, so the first default forcing may already re-bucket.
    Returns the walls and what the adaptive counters moved."""
    from tensorframes_tpu_torch.utils.tracing import counters

    with env_scope(TFT_ADAPTIVE="0", TFT_RESULT_CACHE="0"):
        t0 = time.perf_counter()
        blocks = force()
        static_wall = time.perf_counter() - t0
        want = digest_blocks(np, blocks)
    del blocks
    c0 = {k: counters.get(k) for k in ADAPTIVE_COUNTERS}
    walls = []
    with env_scope(TFT_ADAPTIVE="1", TFT_RESULT_CACHE="1"):
        for _ in range(2):
            t0 = time.perf_counter()
            blocks = force()
            walls.append(time.perf_counter() - t0)
            assert digest_blocks(np, blocks) == want, \
                "the default layout differs from TFT_ADAPTIVE=0"
            del blocks
    return {"static_wall_s": static_wall, "default_walls_s": walls,
            "counts": {k: counters.get(k) - c0[k] for k in ADAPTIVE_COUNTERS}}


def digest_blocks(np, blocks) -> list:
    """Every block's row count and every column's sha256 (``digest``)."""
    return [(b.num_rows, {n: digest(np, np.asarray(c))
                          for n, c in b.columns.items()}) for b in blocks]


def phase_adaptive(ttf, np, torch, n=20_000_000, parts=200,
                   ysb_events_n=2_000_000, seed=41) -> dict:
    """Adaptive execution on the card (see the module docstring, phase
    3k)."""
    from tensorframes_tpu_torch.plan import adaptive
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    df = ttf.frame({"x": x, "k": rng.integers(0, 1_000, n)},
                   num_partitions=parts)
    df.cache()
    f = lambda x: {"z": x * 2.0 + 1.0}        # noqa: E731
    q = lambda z: z > 0.5                     # noqa: E731

    def chain(frame):
        return frame.map_rows(f).filter(q).select(["k", "z"])

    def timed(frame):
        s0 = tracing.timings.snapshot()
        t0 = time.perf_counter()
        blocks = chain(frame).blocks()
        wall = time.perf_counter() - t0
        s1 = tracing.timings.snapshot()
        dispatches = (s1.get("executor.dispatch", {}).get("count", 0)
                      - s0.get("executor.dispatch", {}).get("count", 0))
        return blocks, wall, dispatches

    out = {"rows": n, "blocks": parts}
    adaptive.invalidate_results()
    # (a) the re-bucketed layout: the first forcing measures, later ones
    # coalesce 200 blocks of 100,000 rows; static (=0) and adaptive
    # forcings alternate (static, adaptive, adaptive, static) so that
    # neither always runs later; all bit-identical to =0
    walls = {"0": [], "1": []}
    dispatches = {}
    with env_scope(TFT_RESULT_CACHE="0"):
        l0 = counters.get("plan.adaptive_layouts")
        first, first_wall, first_disp = timed(df)
        assert counters.get("plan.adaptive_layouts") == l0, \
            "the first forcing of a plan shape must run the static layout"
        for knob in ("0", "1", "1", "0"):
            with env_scope(TFT_ADAPTIVE=knob):
                blocks, wall, dispatches[knob] = timed(df)
            walls[knob].append(wall)
            if knob == "0":
                static = blocks
            else:
                second = blocks
        assert counters.get("plan.adaptive_layouts") == l0 + 2
    static_disp, second_disp = dispatches["0"], dispatches["1"]
    want = digest_blocks(np, static)
    zs = 2.0 * x + 1.0
    assert np.array_equal(np.concatenate([b.columns["z"] for b in static]),
                          zs[zs > 0.5]), "the static chain is wrong"
    for blocks in (first, second):
        assert digest_blocks(np, blocks) == want, \
            "the adaptive layout differs from TFT_ADAPTIVE=0"
    out["layout"] = {"static_walls_s": walls["0"],
                     "static_dispatches": static_disp,
                     "measuring_wall_s": first_wall,
                     "adaptive_walls_s": walls["1"],
                     "adaptive_dispatches": second_disp,
                     "coalesces": counters.get("plan.adaptive_coalesces")}
    assert second_disp < static_disp, (second_disp, static_disp)

    # (b) a mid-plan re-plan on a shifted distribution: priced on a warm
    # frame where the second filter keeps every row, then forced where it
    # keeps 0.5% of them
    q1 = lambda z: z > -1e300                 # noqa: E731
    q2 = lambda z: z < -4.0                   # noqa: E731

    def shifted(frame):
        return frame.map_rows(f).filter(q1).filter(q2).select(["z"])

    with env_scope(TFT_RESULT_CACHE="0", TFT_REPLAN_RATIO="3"):
        warm = ttf.frame({"x": np.full(2_000, -3.0)}, num_partitions=parts)
        warm.cache()
        shifted(warm).blocks()
        shifted(warm).blocks()
        r0 = counters.get("plan.replans")
        t0 = time.perf_counter()
        replanned = shifted(df).blocks()
        replan_wall = time.perf_counter() - t0
        assert counters.get("plan.replans") == r0 + 1, "no mid-plan re-plan"
    with env_scope(TFT_ADAPTIVE="0", TFT_RESULT_CACHE="0"):
        assert digest_blocks(np, replanned) == \
            digest_blocks(np, shifted(df).blocks()), \
            "the re-planned run differs from TFT_ADAPTIVE=0"
    out["replan"] = {"wall_s": replan_wall,
                     "kept_rows": sum(b.num_rows for b in replanned)}

    # (c) the result cache: the same plan forced three times; the third
    # is a hit with no dispatch
    adaptive.invalidate_results()
    plan_walls, plan_disp = [], []
    h0 = counters.get("plan.result_cache_hits")
    for _ in range(3):
        blocks, wall, disp = timed(df)
        plan_walls.append(wall)
        plan_disp.append(disp)
        assert digest_blocks(np, blocks) == want
    assert counters.get("plan.result_cache_hits") == h0 + 1
    assert plan_disp[2] == 0, plan_disp
    out["result_cache"] = {"miss_wall_s": plan_walls[0],
                           "admit_wall_s": plan_walls[1],
                           "hit_wall_s": plan_walls[2],
                           "hit_dispatches": plan_disp[2],
                           "stats": adaptive.result_cache_stats()}
    adaptive.invalidate_results()
    del df, static, first, second, replanned, x, zs

    # (d) the YSB query at reduced depth: adaptive batches against a
    # fixed batch_rows, both equal to numpy's counts
    batches, _, table = ysb_events(np, ysb_events_n, 50_000, 100_000,
                                   seed=seed)
    counts = ysb_reference(np, batches, table)["counts"]
    from tensorframes_tpu_torch import stream
    ysb = {}
    for name, rows in (("fixed", 200_000), ("adaptive", "adaptive")):
        src = stream.GeneratorSource(iter([dict(b) for b in batches]))
        t0 = time.perf_counter()
        h = ysb_query(ttf, torch, src, table).start(name=f"ysb-{name}",
                                                    batch_rows=rows)
        h.run()
        wall = time.perf_counter() - t0
        ysb_check(np, h.collect_updates(), counts)
        ysb[name] = {"wall_s": wall, "batches": h.metrics()["batches"]}
    out["stream"] = {"events": ysb_events_n, "source_batch": 50_000, **ysb}
    return out


KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-2}


# ---------------------------------------------------------------------------
# phase 3l: serving three tenants through the scheduler
# ---------------------------------------------------------------------------

def etl_z(x):
    """The reference workload's program (module level: one function, so
    that the etl tenant's queries share one captured program)."""
    return {"z": x + x}


SERVE_CHILD = r'''
import json
import os
import signal
import sys
import time

t_start = time.perf_counter()
import numpy as np
import torch

import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch.observability import baseline
from tensorframes_tpu_torch.ops import segment_reduce
from tensorframes_tpu_torch.plan import adaptive

args = json.loads(sys.argv[1])
device = args["device"]
ttf.set_default_device(device)
if device == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
report = {"pid": os.getpid(), "start_s": time.perf_counter() - t_start}

# the baseline phase 3l(e) persisted for the dashboard chain
df = ttf.read_parquet(args["path"])
with ttf.dsl.with_graph():
    z = (ttf.block(df, "x") + ttf.block(df, "y")).named("z")
cut = args["cut"]
chain = (df.map_blocks(z).filter(lambda ts: ts >= cut)
         .map_rows(lambda z: {"w": z * 2.0}).select(["key", "w"]))
fp, portable = adaptive.aggregate_fingerprint(chain.group_by("key"),
                                             {"w": "sum"})
bl = baseline.baseline_for(fp)
report.update(fingerprint=fp, portable=portable,
              baseline_samples=bl.count if bl is not None else 0)

rng = np.random.default_rng(args["seed"])
key = rng.integers(0, args["keys"], args["n"])
x = rng.random(args["n"])


def query(n):
    frame = ttf.frame({"key": key[:n], "x": x[:n]},
                      num_partitions=args["parts"])
    return frame.map_blocks(lambda x: {"z": x + x}).select(["key", "z"]) \
        .group_by("key")


done = []
for i in range(3):
    # the keyed sum runs on the scheduler's worker, B1 included
    fut = ttf.submit(query(args["small"]), {"z": "sum"}, tenant="child")
    out = fut.result(timeout=600)
    done.append({"query": fut.query_id,
                 "sum": float(out.blocks()[0].columns["z"].sum())})
# the future resolves just before the archive's append: wait for it
for _ in range(400):
    if len(ttf.history(tenant="child", outcome="completed")) >= 3:
        break
    time.sleep(0.05)
report["done"] = done
report["archived"] = len(ttf.history(tenant="child", outcome="completed"))
fut = ttf.submit(query(args["n"]), {"z": "sum"}, tenant="child")
while fut.state != "running":
    time.sleep(0.001)
report["launches"] = segment_reduce.launches
report["killed_query"] = fut.query_id
report["wall_s"] = time.perf_counter() - t_start
print(json.dumps(report), flush=True)
os.kill(os.getpid(), signal.SIGKILL)
'''


def median_mad(np, values) -> tuple:
    a = np.asarray(values, dtype=np.float64)
    med = float(np.median(a))
    return med, float(np.median(np.abs(a - med)))


def phase_serve_three_tenants(ttf, np, torch, segment_reduce,
                              n=20_000_000, parts=8, keys=100_000,
                              groups=20, ssb_rows=6_000_000,
                              whale_rows=8_000_000, whale_parts=8,
                              preempt_parts=80, child_small=2_000_000,
                              device="cuda", profile=True,
                              out=None) -> dict:
    """Serving on the card (``serve_three_tenants_20M``, phase 3l): three
    tenants through one ``QueryScheduler``, rejections, quarantine, both
    kinds of preemption, the regression drill, SLOs, the durable history
    across a SIGKILLed child, reports and the card's busy share. Every
    served query is a keyed ``aggregate``, submitted as its grouped frame
    and fetches and run whole on a worker, B1 included.
    ``out["child_launches"]`` receives the child's segment_sum launches.
    ``device="cpu"`` with ``profile=False`` rehearses it on the CPU."""
    import signal
    import shutil

    import pyarrow.parquet as pq

    from tensorframes_tpu_torch import serve
    from tensorframes_tpu_torch.engine import executor as engine_executor
    from tensorframes_tpu_torch.observability import baseline, flight
    from tensorframes_tpu_torch.observability import device as obs_device
    from tensorframes_tpu_torch.observability import history, slo
    from tensorframes_tpu_torch.plan import adaptive
    from tensorframes_tpu_torch.resilience import (
        AdmissionDeadline, OverQuota, QueryCancelled, QueryQuarantined,
        QueueFull, error_kind, faults)
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    TenantQuota = serve.TenantQuota
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    persist_dir = os.path.join(root, "build", "serve_persist")
    shutil.rmtree(persist_dir, ignore_errors=True)
    summary = {"rows": n, "partitions": parts, "keys": keys}

    def part(name, t0, **info):
        info = {"part": name, "wall_s": time.perf_counter() - t0, **info}
        summary[name] = info["wall_s"]
        emit(info)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # -- the data: phase 2's rows, phase 3b's file, phase 3c's tables ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    path, write_s = scan_file(np, n, groups, keys, 11)
    cut = n // 2
    tbl = pq.read_table(path, columns=["ts", "key", "x", "y"])
    ts, pkey = tbl.column("ts").to_numpy(), tbl.column("key").to_numpy()
    kept = ts >= cut
    dash_want = np.bincount(pkey[kept], weights=(
        tbl.column("x").to_numpy()[kept]
        + tbl.column("y").to_numpy()[kept]) * 2.0, minlength=keys)
    del tbl, ts, pkey, kept
    etl_want = np.bincount(key, weights=2 * x, minlength=keys)
    tables = ssb_tables(np, ssb_rows)
    q21_want = ssb_reference(np, tables, q21=True)
    etl_source = ttf.frame({"key": key, "x": x}, num_partitions=parts)
    data_s = time.perf_counter() - t0

    def dash_chain():
        df = ttf.read_parquet(path)
        with ttf.dsl.with_graph():
            z = (ttf.block(df, "x") + ttf.block(df, "y")).named("z")
        return (df.map_blocks(z).filter(lambda ts: ts >= cut)
                .map_rows(lambda z: {"w": z * 2.0}).select(["key", "w"]))

    # a query is a grouped frame and its fetches: ``sched.submit(*q)``
    # serves ``aggregate(fetches, grouped)``, ``alone(q)`` forces it here
    def dashboard():
        return dash_chain().group_by("key"), {"w": "sum"}

    def etl(fn=etl_z, source=etl_source):
        return (source.map_blocks(fn).select(["key", "z"]).group_by("key"),
                {"z": "sum"})

    def adhoc():
        return (ssb_chain(ttf, tables, parts).group_by("d_year", "p_brand1"),
                {"lo_revenue": "sum"})

    def alone(q):
        return ttf.aggregate(q[1], q[0])

    def cols(frame):
        return frame.blocks()[0].columns

    def q21_cols(frame):
        return cols(frame.order_by("d_year", "p_brand1"))

    read = {"dashboard": cols, "etl": cols, "adhoc": q21_cols}

    def check_dash(c):
        nz = np.flatnonzero(dash_want)
        np.testing.assert_array_equal(c["key"], nz)
        np.testing.assert_allclose(c["w"], dash_want[nz], rtol=1e-12)

    def check_etl(c):
        np.testing.assert_array_equal(c["key"], np.arange(keys))
        np.testing.assert_allclose(c["z"], etl_want, rtol=1e-12)

    def check_q21(c):
        for k in ("d_year", "p_brand1"):
            np.testing.assert_array_equal(c[k], q21_want[k])
        assert np.array_equal(c["lo_revenue"].astype(np.int64),
                              q21_want["lo_revenue"].astype(np.int64))

    def same(a, b) -> bool:
        return all(np.array_equal(a[k], b[k]) for k in b) and \
            list(a) == list(b)

    with env_scope(TFT_RESULT_CACHE="0"):
        # -- the serial forcings: each tenant's query alone -----------------
        # each forced three times: the first may pay for first captures,
        # so a tenant's serial wall is the median of the two warm ones
        t0 = time.perf_counter()
        serial, serial_launches, serial_walls = {}, {}, {}
        all_walls = {}
        for name, build, check in (("dashboard", dashboard, check_dash),
                                   ("etl", etl, check_etl),
                                   ("adhoc", adhoc, check_q21)):
            all_walls[name] = []
            for rep in range(3):
                l0 = segment_reduce.launches
                t1 = time.perf_counter()
                got = read[name](alone(build()))
                sync()
                all_walls[name].append(time.perf_counter() - t1)
                launched = segment_reduce.launches - l0
                if rep == 0:
                    serial[name], serial_launches[name] = got, launched
                    check(got)
                else:
                    assert same(got, serial[name]), name
                    assert launched == serial_launches[name], name
            serial_walls[name] = median_mad(np, all_walls[name][1:])[0]
        assert serial_launches["dashboard"] == groups // 2, serial_launches
        assert serial_launches["etl"] == parts, serial_launches
        assert serial_launches["adhoc"] == parts, serial_launches
        # phase 3m serves the same tenants through the fabric and holds
        # its results against these serial forcings (and (a)'s interner
        # and (c)'s 80-block etl, filled in below)
        shared = {"dashboard": dashboard, "etl": etl, "adhoc": adhoc,
                  "alone": alone, "read": read, "same": same,
                  "serial": serial, "serial_launches": serial_launches,
                  "key": key, "x": x, "preempt_parts": preempt_parts,
                  "path": path, "cut": cut}
        if out is not None:
            out["tenants"] = shared
        part("3l_serial", t0, walls_s=all_walls,
             warm_median_walls_s=serial_walls,
             launches=serial_launches, data_s=data_s,
             file_write_s=write_s)

        # -- (a) the mix: three tenants, three workers ----------------------
        t0 = time.perf_counter()
        tracing.histograms.reset()  # (f) counts (a)'s completions only
        slo.clear_slos()
        # objectives on histogram bucket edges: 30 s above every wall,
        # 0.5 ms below every etl wall
        dash_obj_ms, etl_obj_ms = 30_000.0, 0.5
        slo.set_slo("dashboard", dash_obj_ms, target=0.99)
        slo.set_slo("adhoc", dash_obj_ms, target=0.99)
        slo.set_slo("etl", etl_obj_ms, target=0.99)
        burns = []
        burn_key = slo.on_burn(lambda t, s: burns.append(
            (t, s["burn_rate"])), threshold=1.0, name="chip_smoke")
        quotas = {"dashboard": TenantQuota(weight=2.0, max_inflight=2),
                  "etl": TenantQuota(weight=1.0),
                  "adhoc": TenantQuota(weight=1.0)}
        futs = {}
        l0 = segment_reduce.launches
        owners, hits = {}, []
        with serve.QueryScheduler(quotas=quotas, workers=3,
                                  name="mix") as sched:
            intern = sched._interner_fn

            def spy(comp):
                canon = intern(comp)
                q = flight.current_query()
                owners.setdefault(id(canon), q)
                if canon is not comp:
                    hits.append((q, owners[id(canon)]))
                return canon

            engine_executor.set_computation_interner(spy)
            # every query built first, then each tenant's thread submits
            # its own at one barrier: the picks start from full queues
            work = {"dashboard": [dashboard() for _ in range(4)],
                    "etl": [etl() for _ in range(4)],
                    "adhoc": [adhoc() for _ in range(4)]
                    + [etl(lambda x: {"z": x + x})]}
            fresh = ("adhoc", 4)
            for tenant, qs in work.items():
                for i, q in enumerate(qs):
                    # the fingerprint a submission takes (one torch.export
                    # per new program, under the process's export lock),
                    # taken here so that the submissions land together;
                    # all but the fresh program's, whose submit is timed
                    if (tenant, i) != fresh:
                        adaptive.aggregate_fingerprint(*q)
            barrier = threading.Barrier(len(work))
            submit_s = {}

            def submit_all(tenant):
                barrier.wait()
                for i, q in enumerate(work[tenant]):
                    t1 = time.perf_counter()
                    futs[(tenant, i)] = sched.submit(*q, tenant=tenant)
                    submit_s[(tenant, i)] = time.perf_counter() - t1

            threads = [threading.Thread(target=submit_all, args=(t,))
                       for t in work]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            results = {k: (cols if k == fresh else read[k[0]])(
                f.result(timeout=900)) for k, f in futs.items()}
            sync()
            mix_wall = time.perf_counter() - t0
            engine_executor.set_computation_interner(intern)
            snap = sched.snapshot()
            cache = sched.compile_cache.stats()
        mix_launches = segment_reduce.launches - l0
        tenant_of = {f.query_id: k[0] for k, f in futs.items()}
        assert len(set(tenant_of)) == len(futs), "a query id repeats"
        for (tenant, i), c in results.items():
            program = "etl" if (tenant, i) == fresh else tenant
            assert same(c, serial[program]), \
                f"{tenant} query {i} differs from its serial forcing"
        for tenant in work:
            assert snap[tenant]["completed"] == len(work[tenant]), snap
            assert snap[tenant]["failed"] == snap[tenant]["shed"] == 0
        want_launches = 4 * serial_launches["dashboard"] + \
            5 * serial_launches["etl"] + 4 * serial_launches["adhoc"]
        assert mix_launches == want_launches, (mix_launches, want_launches)
        cross = [(q, o) for q, o in hits
                 if q in tenant_of and o in tenant_of
                 and tenant_of[q] != tenant_of[o]]
        assert cross, "no cross-tenant interner hit: " + repr((sorted(
            {(tenant_of.get(q, q), tenant_of.get(o, o)) for q, o in hits}),
            cache))
        starts = [r["query"] for r in flight.recent(kind="serve.start")
                  if r.get("query") in tenant_of]
        picks = [tenant_of[q] for q in starts]
        last = {t: max(i for i, p in enumerate(picks) if p == t)
                for t in work}
        head = picks[:min(last.values())]
        share = head.count("dashboard") / max(len(head), 1)
        assert 0.25 <= share <= 1.0, (picks, share)
        walls = {t: [futs[k].finished_at - futs[k].submitted_at
                     for k in futs if k[0] == t] for t in work}
        shared["mix_cache"] = cache
        part("3l_a_mix", t0, mix_wall_s=mix_wall,
             fresh_program_submit_s=submit_s[fresh],
             submit_s={t: [submit_s[(t, i)] for i in range(len(work[t]))]
                       for t in work},
             serial_sum_s=4 * serial_walls["dashboard"]
             + 5 * serial_walls["etl"] + 4 * serial_walls["adhoc"],
             query_walls_s=walls, picks=picks,
             dashboard_share_while_all_queued=share,
             launches=mix_launches, serial_launches=want_launches,
             interner=cache, cross_tenant_hits=len(cross),
             snapshot=snap)

        # -- (f) SLOs, over (a)'s completions --------------------------------
        t0 = time.perf_counter()
        status = slo.slo_status()
        slo.remove_burn_callback(burn_key)
        for tenant, obj_ms in (("dashboard", dash_obj_ms),
                               ("etl", etl_obj_ms)):
            good = sum(1 for w in walls[tenant] if w <= obj_ms / 1000.0)
            s = status[tenant]
            assert (s["good"], s["bad"]) == \
                (good, len(walls[tenant]) - good), (tenant, s, good)
        assert status["dashboard"]["bad"] == 0, status["dashboard"]
        assert status["etl"]["burn_rate"] > 1.0, status["etl"]
        assert [t for t, _ in burns] == ["etl"], burns
        part("3l_f_slo", t0, slo={t: status[t] for t in
                                  ("dashboard", "etl")},
             burns=burns)

        # -- (b) rejections, cancels and quarantine ---------------------------
        t0 = time.perf_counter()
        small = ttf.frame({"key": key[:200_000], "x": x[:200_000]},
                          num_partitions=4)
        kinds = {}
        with serve.QueryScheduler(workers=0, name="reject") as s:
            s.register_tenant("dashboard", TenantQuota(max_queue=1))
            queued = s.submit(*etl(source=small), tenant="dashboard")
            try:
                s.submit(*etl(source=small), tenant="dashboard")
                raise AssertionError("a full queue accepted a query")
            except QueueFull as e:
                kinds["queue_full"] = error_kind(e)
            s.register_tenant("etl", TenantQuota(rows_per_sec=n / 10))
            try:
                s.submit(*etl(), tenant="etl")
                raise AssertionError("an over-quota query was accepted")
            except OverQuota as e:
                kinds["over_quota"] = error_kind(e)
            assert s.cancel(queued.query_id)
            try:
                queued.result(timeout=5)
                raise AssertionError("a cancelled query returned")
            except QueryCancelled as e:
                kinds["cancel_queued"] = error_kind(e)
            assert queued.state == "cancelled" and not s.step()
        c0 = counters.get("pipeline.cancelled_streams")
        with serve.QueryScheduler(workers=1, name="cancel") as s:
            many = ttf.frame({"key": key, "x": x},
                             num_partitions=preempt_parts)
            q = s.submit(*etl(source=many), tenant="etl")
            while q._scope is None and not q.done():
                time.sleep(0.0005)
            assert s.cancel(q.query_id)
            try:
                q.result(timeout=300)
                raise AssertionError("a cancelled running query returned")
            except QueryCancelled as e:
                kinds["cancel_running"] = error_kind(e)
            cancelled_at = s.snapshot()["etl"]
        cancelled_streams = counters.get("pipeline.cancelled_streams") - c0
        assert cancelled_streams == 1, cancelled_streams
        assert kinds == {"queue_full": "rejected",
                         "over_quota": "over_quota",
                         "cancel_queued": "cancelled",
                         "cancel_running": "cancelled"}, kinds
        # a program failing permanently, three times: quarantined
        q0 = counters.get("serve.quarantines")
        with serve.QueryScheduler(workers=1, name="poison") as s:
            for _ in range(3):
                faults.arm("dispatch", 2, message="injected plan bug",
                           transient=False)
                fut = s.submit(*etl(source=small), tenant="adhoc")
                try:
                    fut.result(timeout=120)
                    raise AssertionError("the poison query succeeded")
                except faults.InjectedFault:
                    pass
                faults.reset("dispatch")
            try:
                s.submit(*etl(source=small), tenant="adhoc")
                raise AssertionError("a quarantined plan was accepted")
            except QueryQuarantined as e:
                kinds["quarantined"] = error_kind(e)
            status_q = serve.quarantine_status()
            lifted = ttf.unquarantine()
            after = cols(s.submit(*etl(source=small), tenant="adhoc")
                         .result(timeout=120))
        assert counters.get("serve.quarantines") - q0 == 1
        assert kinds["quarantined"] == "quarantined" and lifted == 1
        np.testing.assert_allclose(after["z"], np.bincount(
            key[:200_000], weights=2 * x[:200_000], minlength=keys)[
                after["key"]], rtol=1e-12)
        part("3l_b_rejections", t0, kinds=kinds,
             cancelled_streams=cancelled_streams,
             cancel_snapshot=cancelled_at,
             quarantined=list(status_q["active"]), lifted=lifted)

        # -- (c) priority preemption: dashboard outweighs a running etl ------
        t0 = time.perf_counter()
        many = ttf.frame({"key": key, "x": x}, num_partitions=preempt_parts)
        l0 = segment_reduce.launches
        whole = cols(alone(etl(source=many)))
        alone_launches = segment_reduce.launches - l0
        check_etl(whole)
        p0 = {k: counters.get(k) for k in ("pipeline.parked_blocks",
                                           "pipeline.resumed_blocks",
                                           "serve.preemptions")}
        with env_scope(TFT_PREEMPT_AFTER_MS="0"):
            with serve.QueryScheduler(
                    quotas={"etl": TenantQuota(weight=1.0),
                            "dashboard": TenantQuota(weight=4.0)},
                    workers=1, name="prio") as s:
                l0 = segment_reduce.launches
                whale = s.submit(*etl(source=many), tenant="etl")
                while whale._scope is None and not whale.done():
                    time.sleep(0.0005)
                vip = s.submit(*dashboard(), tenant="dashboard")
                vip_cols = cols(vip.result(timeout=600))
                got = cols(whale.result(timeout=600))
                sync()
                prio_launches = segment_reduce.launches - l0
                order = [r["query"] for r in flight.recent(
                    kind="serve.start") if r.get("query") in
                    (whale.query_id, vip.query_id)]
        moved = {k: counters.get(k) - v for k, v in p0.items()}
        assert whale.preemptions == 1, whale.preemptions
        assert order == [whale.query_id, vip.query_id, whale.query_id], \
            order
        assert same(got, whole), "the resumed etl differs"
        assert same(vip_cols, serial["dashboard"])
        assert prio_launches == alone_launches + \
            serial_launches["dashboard"], (prio_launches, alone_launches)
        assert moved["pipeline.parked_blocks"] >= 1
        assert moved["pipeline.resumed_blocks"] == \
            moved["pipeline.parked_blocks"], moved
        shared.update(whole=whole, alone_launches=alone_launches)
        part("3l_c_priority_preempt", t0, counts=moved,
             partitions=preempt_parts, launches=prio_launches,
             alone_launches=alone_launches,
             walls_s={"whale": whale.finished_at - whale.submitted_at,
                      "vip": vip.finished_at - vip.submitted_at})

        # -- (d) admission against the card's memory --------------------------
        t0 = time.perf_counter()
        jl = jl_tables(np, whale_rows)
        P = torch.from_numpy(jl["P"]).to(device)
        block_bytes = whale_rows // whale_parts * 64 * 4

        whale_frame = (jl_select(ttf, P, jl, whale_parts).group_by("key"),
                       {"z": "sum"})
        # the whale's estimate is its input (the chain's output estimate
        # would be its 12 bytes a row); the limit leaves it exactly room
        whale_est = int(jl["x"].nbytes + jl["key"].nbytes)
        live0 = obs_device.watermark()["live_bytes"] \
            if obs_device.watermark() else 0
        # the whale fits beside what the card holds now, with half a
        # block to spare for what it allocates before its admission; an
        # arrival a block short of that fits only once the whale's
        # blocks (two or three in flight while it streams) leave the card
        margin = block_bytes // 2
        limit = int((live0 + whale_est + margin) / 0.9) + 1
        arrival_est = whale_est + margin - block_bytes
        a0 = counters.get("serve.admission_preempts")
        with env_scope(TFT_SERVE_HBM_LIMIT_BYTES=str(limit),
                       TFT_SERVE_ADMISSION_WAIT_S="60",
                       TFT_SERVE_ADMISSION_POLL_S="0.005"):
            with serve.QueryScheduler(workers=2, name="admit") as s:
                wq = s.submit(*whale_frame, tenant="etl",
                              est_bytes=whale_est)
                # the whale holds at least two blocks on the card
                while not wq.done():
                    wm = obs_device.watermark()
                    if wq._scope is not None and wm and \
                            wm["live_bytes"] >= live0 + 2 * block_bytes:
                        break
                    time.sleep(0.0005)
                live_whale = obs_device.watermark()["live_bytes"]
                arrival = s.submit(*etl(source=small), tenant="dashboard",
                                   est_bytes=arrival_est)
                arrival_cols = cols(arrival.result(timeout=600))
                whale_cols = cols(wq.result(timeout=600))
        admission_preempts = counters.get("serve.admission_preempts") - a0
        assert admission_preempts == 1, admission_preempts
        assert wq.preemptions == 1 and wq.state == "done", wq
        zs = ((jl["x"].astype(np.float64) @ jl["P"].astype(np.float64))
              ** 2).sum(-1)
        jl_want = np.bincount(jl["key"], weights=zs, minlength=100_000)
        absz = np.bincount(jl["key"], weights=np.abs(zs), minlength=100_000)
        k = whale_cols["key"]
        assert np.all(np.abs(whale_cols["z"] - jl_want[k])
                      <= 1e-5 * absz[k] + 1e-6), "the whale's sums differ"
        assert arrival.state == "done" and len(arrival_cols["key"])
        del jl, P, whale_frame, zs
        # an arrival larger than the limit is shed within the wait
        with env_scope(TFT_SERVE_HBM_LIMIT_BYTES=str(limit),
                       TFT_SERVE_ADMISSION_WAIT_S="1"):
            with serve.QueryScheduler(workers=1, name="shed") as s:
                t1 = time.perf_counter()
                big = s.submit(*etl(source=small), tenant="etl",
                               est_bytes=limit + 1)
                try:
                    big.result(timeout=60)
                    raise AssertionError("an oversized query ran")
                except AdmissionDeadline as e:
                    shed_kind = error_kind(e)
                shed_s = time.perf_counter() - t1
        assert big.state == "shed" and shed_kind == "deadline_admission"
        assert shed_s < 5.0, shed_s
        part("3l_d_admission", t0, limit_bytes=limit, live0_bytes=live0,
             live_with_whale_bytes=live_whale, whale_est_bytes=whale_est,
             arrival_est_bytes=arrival_est, block_bytes=block_bytes,
             admission_preempts=admission_preempts,
             whale_preemptions=wq.preemptions, shed_s=shed_s,
             shed_est_bytes=limit + 1)

        # -- (e) the regression drill -----------------------------------------
        t0 = time.perf_counter()
        baseline.clear()
        flight.clear()
        with env_scope(TFT_PERSIST_DIR=persist_dir):
            history.clear()
            # driven by step(): each query's finish (its baseline and
            # regression check) is done when step() returns
            with serve.QueryScheduler(workers=0, name="drill") as s:
                warm = []
                for _ in range(6):
                    fut = s.submit(*dashboard(), tenant="dashboard")
                    assert s.step()
                    assert same(cols(fut.result(timeout=600)),
                                serial["dashboard"])
                    warm.append(fut.finished_at - fut.started_at)
                report = ttf.last_query_report()
                med, mad = median_mad(np, warm)
                assert ttf.regressions() == [], ttf.regressions()
                # one median at least, and far enough past the warm runs'
                # spread that the regression's guards hold on any host
                slow_s = max(med, 8 * (1.4826 * mad + 0.005), 0.1)
                with env_scope(TFT_FAULT_PERF_S=str(slow_s)):
                    faults.arm("perf", 1)
                    slow = s.submit(*dashboard(), tenant="dashboard")
                    assert s.step()
                    slow.result(timeout=600)
                    faults.reset("perf")
                regs = ttf.regressions()
                fp = adaptive.aggregate_fingerprint(*dashboard())
                assert fp is not None and fp[1], fp
                # the bare chain keys a baseline of its own
                assert adaptive.query_fingerprint(dash_chain())[0] != fp[0]
                assert len(regs) == 1, regs
                reg = regs[0]
                assert reg["fingerprint"] == fp[0], (reg, fp)
                assert reg["component"] == "stage_wall_s", reg
                assert reg["query"] == slow.query_id
                why = ttf.why(slow.query_id)
                assert "PERF REGRESSION" in why and "stage_wall_s" in why
                doc = ttf.doctor()
                assert fp[0][:16] in doc, doc
                warns = [w for w in ttf.health()["warnings"]
                         if w.startswith("perf:")]
                assert len(warns) == 1 and "stage_wall_s" in warns[0]
                assert "PERF: 1 regression(s)" in ttf.serve_report(s)
            persisted = baseline.baseline_for(fp[0])
            assert persisted is not None and persisted.count == 7
        part("3l_e_regression_drill", t0, warm_walls_s=warm,
             warm_median_s=med, warm_mad_s=mad, fault_perf_s=slow_s,
             slow_wall_s=slow.finished_at - slow.started_at,
             regression=reg, fingerprint=fp[0])

        # -- (h) reports ------------------------------------------------------
        t0 = time.perf_counter()
        for needle in ("rows     :", "block(s)", "marshalled",
                       "wall time by stage", "plan.execute"):
            assert needle in report, (needle, report)
        if device == "cuda":
            assert "peak HBM" in report, report
        snap = ttf.health()
        json.dumps(snap)
        mem = snap["memory"]["device"]
        if device == "cuda":
            assert mem is not None and mem["limit_bytes"] > 0, mem
        part("3l_h_reports", t0, last_query_report=report.splitlines(),
             health_memory=snap["memory"], health_keys=sorted(snap))

        # -- (g) the durable history across a process death -----------------
        t0 = time.perf_counter()
        hist_dir = os.path.join(persist_dir, "history")
        arg = json.dumps({"device": device, "path": path, "cut": cut,
                          "seed": 2, "keys": keys, "n": n, "parts": parts,
                          "small": child_small})
        env = dict(os.environ, TFT_HISTORY_DIR=hist_dir,
                   TFT_PERSIST_DIR=persist_dir, TFT_RESULT_CACHE="0")
        res = subprocess.run([sys.executable, "-c", SERVE_CHILD, arg],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        if res.stderr:
            sys.stderr.write(res.stderr[-4000:])
        assert res.returncode == -signal.SIGKILL, res.returncode
        child = json.loads(res.stdout.strip().splitlines()[-1])
        if out is not None:
            out["child_launches"] = child["launches"]
        assert child["portable"] and child["fingerprint"] == fp[0]
        assert child["baseline_samples"] >= 6, child
        assert child["archived"] == 3, child
        with env_scope(TFT_HISTORY_DIR=hist_dir):
            history.clear()
            flight.clear()
            unclean = history.unclean_shutdown()
            assert unclean is not None and unclean["pid"] == child["pid"]
            pm = ttf.postmortem()
            assert "UNCLEAN SHUTDOWN" in pm and str(child["pid"]) in pm
            recs = ttf.history(tenant="child", outcome="completed")
            assert [r["query"] for r in recs] == \
                [d["query"] for d in child["done"]], recs
            for r in recs:
                for k in ("tenant", "fingerprint", "cost", "run_s",
                          "total_s", "queued_s"):
                    assert k in r, (k, r)
            why = ttf.why(recs[0]["query"])
            assert "durable history" in why and "serve.finish" in why
        ref_small = float(np.bincount(key[:child_small],
                                      weights=2 * x[:child_small]).sum())
        for d in child["done"]:
            np.testing.assert_allclose(d["sum"], ref_small, rtol=1e-12)
        part("3l_g_history", t0, child_pid=child["pid"],
             child_start_s=child["start_s"], child_wall_s=child["wall_s"],
             child_launches=child["launches"],
             baseline_samples=child["baseline_samples"],
             records=[{k: r.get(k) for k in ("query", "tenant", "outcome",
                                             "run_s", "total_s")}
                      for r in recs],
             postmortem=pm.splitlines()[:3])

        # -- (i) the card's busy share of a served query ----------------------
        if profile:
            t0 = time.perf_counter()
            trace_dir = os.path.join(root, "build", "serve_profile")
            with serve.QueryScheduler(workers=1, name="profile") as s:
                q = dashboard()
                sync()
                t1 = time.perf_counter()
                with tracing.profile(trace_dir) as prof:
                    got = cols(s.submit(*q, tenant="dashboard")
                               .result(timeout=600))
                    sync()
                wall = time.perf_counter() - t1
            assert same(got, serial["dashboard"])
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) * 1e-6
            assert busy > 0, "the profiler saw no device time"
            b1_names = ("radix_hist_kernel", "radix_scatter_kernel",
                        "scan_digits_kernel", "offsets_kernel",
                        "segment_kernel", "head_kernel")
            b1 = sum(e.self_device_time_total for e in kernels
                     if any(nm in e.key for nm in b1_names)) * 1e-3
            kernels.sort(key=lambda e: -e.self_device_time_total)
            part("3l_i_busy_share", t0, wall_s_query=wall,
                 device_busy_s=busy, busy_share=busy / wall,
                 segment_sum_device_ms=b1,
                 top_kernels_ms={e.key[:80]: e.self_device_time_total
                                 * 1e-3 for e in kernels[:6]})
    shutil.rmtree(persist_dir, ignore_errors=True)
    summary["total_s"] = time.perf_counter() - t_phase
    return summary


# ---------------------------------------------------------------------------
# phase 3m: the serving fabric and seeded chaos
# ---------------------------------------------------------------------------

def dash_z(x, y):
    """Phase 3m's pure twin of the dashboard's DSL program ``x + y``
    (module level: one function object, so that every build of the chain
    keys the result cache alike; a DSL program is never cached)."""
    return {"z": x + y}


def dash_w(z):
    """The dashboard chain's ``map_rows``, module level as :func:`dash_z`."""
    return {"w": z * 2.0}


def host_columns(np, frame) -> dict:
    """Every block's columns of a forced frame, concatenated on the
    host."""
    out = {}
    for b in frame.blocks():
        for k, v in b.columns.items():
            out.setdefault(k, []).append(
                np.asarray(v.cpu() if hasattr(v, "cpu") else v))
    return {k: np.concatenate(v) for k, v in out.items()}


def on_host(np, cols) -> dict:
    return {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            for k, v in cols.items()}


def phase_fabric_three_workers(ttf, np, torch, segment_reduce, served,
                               small_rows=200_000, small_parts=4,
                               crash_after=20, drill_rounds=2,
                               device="cuda") -> dict:
    """The serving fabric on the card (``fabric_three_workers_20M``, phase
    3m): phase 3l's three tenants at full size through a three-worker
    ``serve.ServeFabric`` with ``TFT_PERSIST_DIR`` under ``build/``.
    ``served["tenants"]`` is what phase 3l left: its query builders, its
    serial results and launches. (a) four queries a tenant, each its
    grouped frame and fetches, and the etl program once more from adhoc
    (``TFT_RESULT_CACHE=0``): one tenant per worker, every result
    bit-equal to its serial forcing, the launches equal to the serial
    count, the programs interned once for the three workers, as one
    scheduler does, and reused across workers; (b) the worker serving the
    80-block etl is lost mid-query (``worker`` armed once after
    ``crash_after`` of its blocks dispatched): declared lost, the query
    resumed on a survivor from its persisted checkpoint under its id,
    only the blocks the dead worker never finished dispatched again,
    bit-equal, ``why`` one chain across two workers, the two etl queries
    queued behind it re-placed and served, and the card's bytes in use
    back at their value before the fabric opened; (c) a rolling restart
    of the three workers with a query a tenant in flight and
    ``TFT_RESULT_CACHE`` at its default: no query lost, each restarted
    worker's admission probe passed on the card, a repeated dashboard
    chain (pure programs) answered warm from the durable tier with no
    dispatch; (d) the port's chaos drill (``tools.chaos_soak.run_drill``)
    at seed 11, rate 0.3 over its default ``device|worker|preempt|disk``
    (each site firing), ``drill_rounds`` rounds at the drill's own small
    size, the card's
    bytes in use back at their value before it; (e) ``TFT_FABRIC=0``: one
    query bit-equal to a plain scheduler's. ``device="cpu"`` rehearses it
    on the CPU."""
    import gc
    import re
    import shutil

    from tensorframes_tpu_torch import serve
    from tensorframes_tpu_torch.engine import executor as engine_executor
    from tensorframes_tpu_torch.observability import flight, slo
    from tensorframes_tpu_torch.plan import adaptive
    from tensorframes_tpu_torch.resilience import faults
    from tensorframes_tpu_torch.tools import chaos_soak
    from tensorframes_tpu_torch.utils import tracing
    from tensorframes_tpu_torch.utils.tracing import counters

    t = served["tenants"]
    read, same, serial = t["read"], t["same"], t["serial"]
    sl = t["serial_launches"]
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    persist_dir = os.path.join(root, "build", "fabric_persist")
    drill_dir = os.path.join(root, "build", "chaos_persist")
    for d in (persist_dir, drill_dir):
        shutil.rmtree(d, ignore_errors=True)
    summary = {}

    def part(name, t0, **info):
        info = {"part": name, "wall_s": time.perf_counter() - t0, **info}
        summary[name] = info["wall_s"]
        emit(info)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def card_bytes():
        """The card's bytes in use, the result cache dropped first."""
        adaptive.invalidate_results()
        gc.collect()
        sync()
        return torch.cuda.memory_allocated() if device == "cuda" else 0

    def counts(prefix):
        return {k: v for k, v in counters.snapshot().items()
                if k.startswith(prefix)}

    tenants = ("dashboard", "etl", "adhoc")
    quotas = {"dashboard": serve.TenantQuota(weight=2.0, max_inflight=2),
              "etl": serve.TenantQuota(weight=1.0),
              "adhoc": serve.TenantQuota(weight=1.0)}

    def fabric(name):
        # the monitor beats every 100 ms; every worker passes its
        # admission probe on the default device before it takes tenants
        return serve.ServeFabric(workers=3, quotas=quotas, name=name)

    # objectives every query meets, over this phase's completions only: no
    # tenant burns its budget, so the fabric's SLO rebalance keeps one
    # tenant a worker (3l left etl burning)
    tracing.histograms.reset()
    slo.clear_slos()
    for tenant in tenants:
        slo.set_slo(tenant, 600_000.0, target=0.99)

    with env_scope(TFT_RESULT_CACHE="0", TFT_PERSIST_DIR=persist_dir):
        # -- (a) the mix: one tenant a worker --------------------------------
        t0 = time.perf_counter()
        fresh = ("adhoc", 4)

        def etl_fresh():
            # a program object new to the process (3l interned etl_z's
            # own, which short-circuits any later interner): the first
            # of these interns it, the others reuse it, the one from
            # adhoc's worker across workers
            return t["etl"](lambda x: {"z": x + x})

        work = {"dashboard": [t["dashboard"]() for _ in range(4)],
                "etl": [etl_fresh() for _ in range(4)],
                "adhoc": [t["adhoc"]() for _ in range(4)] + [etl_fresh()]}
        owners, hits = {}, []
        m0 = counters.get("serve.compile_cache.misses")
        l0 = segment_reduce.launches
        with fabric("mix") as fab:
            intern = engine_executor.current_computation_interner()

            def spy(comp):
                canon = intern(comp)
                w = flight.current_worker()
                owners.setdefault(id(canon), w)
                if canon is not comp:
                    hits.append((w, owners[id(canon)]))
                return canon

            engine_executor.set_computation_interner(spy)
            futs = {}
            try:
                # each tenant's first query places it (least loaded
                # first); the rest queue behind on the same worker
                for i in range(5):
                    for tenant in tenants:
                        if i < len(work[tenant]):
                            futs[(tenant, i)] = fab.submit(
                                *work[tenant][i], tenant=tenant)
                results = {k: on_host(np, (read["etl"] if k == fresh
                                           else read[k[0]])(
                    f.result(timeout=900))) for k, f in futs.items()}
                sync()
            finally:
                engine_executor.set_computation_interner(intern)
            mix_wall = time.perf_counter() - t0
            placement = fab.health_snapshot()["placement"]
            report_a = fab.placement_report()
            cache = fab.compile_cache.stats()
            shared = all(w.scheduler.compile_cache is fab.compile_cache
                         for w in fab._workers)
            ran_on = {k: sorted({r["worker"] for r in
                                 flight.for_query(f.query_id)
                                 if r.get("worker")})
                      for k, f in futs.items()}
            del futs, work
        # the closed fabric still holds its queries' frames, whose chains
        # cache blocks on the card: drop it before (b) reads the card
        del fab
        mix_launches = segment_reduce.launches - l0
        assert sorted(placement) == sorted(tenants) and \
            len(set(placement.values())) == 3, placement
        for (tenant, i), c in results.items():
            program = "etl" if (tenant, i) == fresh else tenant
            assert same(c, on_host(np, serial[program])), \
                f"{tenant} query {i} differs from its serial forcing"
            assert ran_on[(tenant, i)] == [placement[tenant]], \
                (tenant, i, ran_on[(tenant, i)], placement)
        want_launches = 4 * sl["dashboard"] + 5 * sl["etl"] + \
            4 * sl["adhoc"]
        assert mix_launches == want_launches, (mix_launches, want_launches)
        cross = [(w, o) for w, o in hits if w and o and w != o]
        assert shared and cross, (shared, hits)
        # every program interned once for the three workers: the
        # programs one scheduler interned for 3l's mix, and the admission
        # probe's
        assert cache["misses"] == cache["entries"] == \
            counters.get("serve.compile_cache.misses") - m0 == \
            t["mix_cache"]["entries"] + 1, (cache, t["mix_cache"])
        del results
        part("3m_a_mix", t0, mix_wall_s=mix_wall, placement=placement,
             placement_report=report_a.splitlines(), launches=mix_launches,
             serial_launches=want_launches, interner=cache,
             cross_worker_hits=len(cross))

        # -- (b) a worker lost mid-query -------------------------------------
        t0 = time.perf_counter()
        # everything this part makes is dropped again before the bytes are
        # read after it
        bytes0 = card_bytes()
        parts = t["preempt_parts"]
        many = ttf.frame({"key": t["key"], "x": t["x"]},
                         num_partitions=parts)
        small = ttf.frame({"key": t["key"][:small_rows],
                           "x": t["x"][:small_rows]},
                          num_partitions=small_parts)
        s0 = counters.get("pipeline.submitted")
        l0 = segment_reduce.launches
        small_want = on_host(np, read["etl"](t["alone"](
            t["etl"](source=small))))
        small_launches = segment_reduce.launches - l0
        assert counters.get("pipeline.submitted") - s0 == small_parts
        f0 = counts("fabric.")
        l0 = segment_reduce.launches
        s0 = counters.get("pipeline.submitted")
        with fabric("crash") as fab:
            big = fab.submit(*t["etl"](source=many), tenant="etl")
            queued = [fab.submit(*t["etl"](source=small), tenant="etl")
                      for _ in range(2)]
            victim = fab._workers[fab._placement["etl"]].worker_id
            # the worker dies once it has dispatched `crash_after` blocks
            while counters.get("pipeline.submitted") - s0 < crash_after \
                    and not big.done():
                time.sleep(0.0005)
            faults.arm("worker", 1)
            big_cols = on_host(np, read["etl"](big.result(timeout=900)))
            queued_cols = [on_host(np, read["etl"](q.result(timeout=900)))
                           for q in queued]
            sync()
            faults.reset("worker")
            snap = fab.health_snapshot()
            health_fabric = ttf.health()["fabric"]
            report_b = fab.placement_report()
            qid, attempts = big.query_id, big.attempts
            why = ttf.why(qid)
            recs = flight.for_query(qid)
            queued_recs = [[r for r in flight.for_query(q.query_id)
                            if r["kind"] == "fabric.resume_dispatch"]
                           for q in queued]
            del big, queued
        del fab, many, small
        crash_launches = segment_reduce.launches - l0
        submits = counters.get("pipeline.submitted") - s0
        bytes1 = card_bytes()
        fabric_counts = {k: v - f0.get(k, 0)
                         for k, v in counts("fabric.").items()}
        resume = [r for r in recs if r["kind"] == "fabric.resume_dispatch"]
        assert snap["lost"] == 1 and health_fabric["lost"] == 1 and \
            health_fabric["live"] == 2, (snap, health_fabric)
        assert attempts == 2 and len(resume) == 1, (attempts, resume)
        resumed = resume[0]["resumed_blocks"]
        assert resume[0]["from_checkpoint"] and 0 < resumed < parts, resume
        assert resume[0]["worker"] != victim, (resume, victim)
        redispatched = parts - resumed
        # the dead worker's blocks went to the checkpoint; the survivor
        # dispatched only the rest: no block ran twice
        assert submits == parts + 2 * small_parts, (submits, resumed)
        assert crash_launches == t["alone_launches"] + 2 * small_launches, \
            (crash_launches, t["alone_launches"], small_launches)
        assert same(big_cols, on_host(np, t["whole"])), \
            "the resumed etl differs from its run alone"
        for c in queued_cols:
            assert same(c, small_want), "a re-placed queued query differs"
        for rs in queued_recs:
            assert len(rs) == 1 and not rs[0]["from_checkpoint"], rs
        assert snap["queries"]["done"] == snap["queries"]["total"] == 3
        chain_workers = set(re.findall(r" w=(w\d) ", why))
        assert len(chain_workers) == 2 and "fabric.resume_dispatch" in why \
            and "resume from the persisted checkpoint" in why, why
        assert bytes1 == bytes0, (bytes0, bytes1)
        part("3m_b_worker_lost", t0, victim=victim,
             resumed_blocks=resumed, redispatched_blocks=redispatched,
             blocks=parts, pipeline_submits=submits,
             launches=crash_launches, health_fabric=health_fabric,
             placement_report=report_b.splitlines(),
             why_workers=sorted(chain_workers),
             fabric_counters=fabric_counts, card_bytes_before=bytes0,
             card_bytes_after=bytes1)

    # -- (c) a rolling restart with queries in flight -----------------------
    with env_scope(TFT_PERSIST_DIR=persist_dir):
        t0 = time.perf_counter()
        adaptive.invalidate_results()
        cut = t["cut"]

        def pred(ts):
            return ts >= cut

        def warm_chain():
            df = ttf.read_parquet(t["path"])
            return (df.map_blocks(dash_z).filter(pred).map_rows(dash_w)
                    .select(["key", "w"]))

        w0 = counters.get("plan.result_cache_warm_hits")
        p0 = counters.get("persist.result_writes")
        lost0 = counters.get("fabric.workers_lost")
        admits0 = len(flight.recent(kind="fabric.admit"))
        with fabric("roll") as fab:
            # two forcings admit the chain (two-touch); the admit persists
            cold = host_columns(np, fab.submit(
                warm_chain(), tenant="dashboard").result(timeout=600))
            again = host_columns(np, fab.submit(
                warm_chain(), tenant="dashboard").result(timeout=600))
            writes = counters.get("persist.result_writes") - p0
            inflight = {tenant: fab.submit(*t[tenant](), tenant=tenant)
                        for tenant in tenants}
            while not any(f.state == "running"
                          for f in inflight.values()):
                time.sleep(0.0005)
            t1 = time.perf_counter()
            healthy = fab.rolling_restart()
            restart_s = time.perf_counter() - t1
            epochs = [w.epoch for w in fab._workers]
            got = {tenant: on_host(np, read[tenant](f.result(timeout=900)))
                   for tenant, f in inflight.items()}
            attempts = {tenant: f.attempts for tenant, f in inflight.items()}
            h0 = counters.get("plan.result_cache_warm_hits")
            sub0 = counters.get("pipeline.submitted")
            warm = host_columns(np, fab.submit(
                warm_chain(), tenant="dashboard").result(timeout=600))
            warm_hits = counters.get("plan.result_cache_warm_hits") - h0
            warm_submits = counters.get("pipeline.submitted") - sub0
            snap = fab.health_snapshot()
            del inflight
        del fab
        admits = flight.recent(kind="fabric.admit")[admits0:]
        assert writes >= 1 and same(again, cold), writes
        assert healthy == 3 and epochs == [1, 1, 1], (healthy, epochs)
        # a worker drained for its restart is not a lost one
        assert counters.get("fabric.workers_lost") == lost0 and \
            snap["lost"] == 0, snap
        assert sorted(r["worker"] for r in admits
                      if r.get("epoch") == 1) == ["w0", "w1", "w2"], admits
        for tenant in tenants:
            assert same(got[tenant], on_host(np, serial[tenant])), tenant
        assert snap["queries"]["done"] == snap["queries"]["total"] == 6
        assert warm_hits >= 1 and warm_submits == 0, \
            (warm_hits, warm_submits)
        assert same(warm, cold), "the warm hit differs from its forcing"
        part("3m_c_rolling_restart", t0, healthy=healthy,
             restart_s=restart_s, attempts=attempts,
             warm_hits=counters.get("plan.result_cache_warm_hits") - w0,
             warm_submits=warm_submits, result_writes=writes,
             admits=[(r["worker"], r["epoch"]) for r in admits])

    # -- (d) the chaos drill ------------------------------------------------
    t0 = time.perf_counter()
    bytes0 = card_bytes()
    v0 = counters.get("invariants.violations")
    c0 = counts("chaos.")
    report = chaos_soak.run_drill(seed=11, rate=0.3, rounds=drill_rounds,
                                  persist_dir=drill_dir)
    bytes1 = card_bytes()
    shutil.rmtree(drill_dir, ignore_errors=True)
    fired = sorted({site for site, _ in report["firings"]})
    chaos_counts = {k: v - c0.get(k, 0) for k, v in counts("chaos.").items()}
    assert {"device", "worker", "preempt", "disk"} <= set(fired), fired
    assert all(kind != "permanent" for kind, _ in report["failures"])
    assert counters.get("invariants.violations") == v0
    assert chaos_soak.check_prefix_replay(
        report["firings"], report["consults"], report["replay_firings"],
        report["replay_consults"]) == []
    assert bytes1 == bytes0, (bytes0, bytes1)
    part("3m_d_chaos_drill", t0, seed=11, rate=0.3,
         sites=report["sites"], rounds=drill_rounds, fired_sites=fired,
         fired=report["fired"], firings=report["firings"],
         replay_firings=report["replay_firings"],
         replay_equal=report["firings"] == report["replay_firings"],
         consults=report["consults"],
         failure_kinds=sorted({k for k, _ in report["failures"]}),
         failures=len(report["failures"]), chaos_counters=chaos_counts,
         card_bytes_before=bytes0, card_bytes_after=bytes1)

    # -- (e) TFT_FABRIC=0: one pass-through worker ---------------------------
    t0 = time.perf_counter()
    small = ttf.frame({"key": t["key"][:small_rows],
                       "x": t["x"][:small_rows]}, num_partitions=small_parts)
    with env_scope(TFT_FABRIC="0", TFT_RESULT_CACHE="0",
                   TFT_PERSIST_DIR=persist_dir):
        with serve.QueryScheduler(workers=1, name="plain") as sched:
            plain = on_host(np, read["etl"](sched.submit(
                *t["etl"](source=small), tenant="etl").result(timeout=600)))
        with fabric("off") as fab:
            one = (len(fab._workers), fab.enabled)
            got = on_host(np, read["etl"](fab.submit(
                *t["etl"](source=small), tenant="etl").result(timeout=600)))
    assert one == (1, False) and same(got, plain), one
    part("3m_e_fabric_off", t0, workers=one[0])
    shutil.rmtree(persist_dir, ignore_errors=True)
    assert counts("fabric.rebalances") == {}, counts("fabric.rebalances")
    slo.clear_slos()
    emit({"part": "3m_counters", "fabric": counts("fabric."),
          "chaos": counts("chaos.")})
    summary["total_s"] = time.perf_counter() - t_phase
    return summary


def segment_check(torch, segment_reduce, vals, tid, s, what) -> None:
    """The kernel twice (bit-identical) against the plain version on the
    same values widened to f64, to ``KERNEL_RTOL``."""
    name = str(vals.dtype).replace("torch.", "")
    got = segment_reduce.segment_sum_cuda(vals, tid, s)
    again = segment_reduce.segment_sum_cuda(vals, tid, s)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8)), \
        f"not bit-identical: {name} {what}"
    ref = segment_reduce.segment_sum_reference(vals.double(), tid, s)
    torch.testing.assert_close(got.double(), ref, rtol=KERNEL_RTOL[name],
                               atol=0.0, msg=lambda m: f"{name} {what}: {m}")


def phase_kernel_checks(np, torch, segment_reduce) -> dict:
    """segment_sum against segment_sum_reference on the card, both given
    the same values; the plain version sums them widened to f64 (exact for
    f32 and bf16 inputs), so it is the true sum and the tolerance is the
    kernel's own rounding. f64 to rtol 1e-12 (summation order only); f32 to
    rtol 1e-5 (f32 chains of at most one piece, 64 or 1,024 terms, at each
    of at most 3 levels of the piece tree here); bf16 to rtol 1e-2 (one rounding of the f32
    sum to 8 bits). The plain version in f32 would not do as the yardstick:
    on CUDA its ``index_add_`` adds with atomics in an order that changes
    from run to run, and over 100k rows into one segment its own error is
    1e-5. Besides random ids with dropped ones: a hot segment holding 90%
    of the rows and every row in one segment with S = 1 (also at the
    k-means path's 250,000 x 64 block), and 2^22 rows into 2^27 segments,
    where the sort takes its most passes (4)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    n = 100_003  # a ragged tail for every sort tile and piece
    cases = 0
    for dtype in ("float32", "bfloat16", "float64"):
        tdt = getattr(torch, dtype)
        for s in (1, 1024, 100_000):
            for d in (1, 64):
                ids = rng.integers(0, s, n)
                ids[:: 97] = -1          # dropped
                ids[5:: 101] = s + 3     # dropped: >= S
                for id_dt in (torch.int32, torch.int64):
                    vals = torch.from_numpy(
                        rng.random((n, d)) + 0.5).to(dev, tdt)
                    tid = torch.from_numpy(ids).to(dev, id_dt)
                    segment_check(torch, segment_reduce, vals, tid, s,
                                  f"S={s} d={d} {id_dt}")
                    cases += 1
        for m, d in ((n, 1), (n, 64), (250_000, 64)):
            vals = torch.from_numpy(rng.random((m, d)) + 0.5).to(dev, tdt)
            hot = np.where(rng.random(m) < 0.9, 17, rng.integers(0, 1024, m))
            segment_check(torch, segment_reduce, vals,
                          torch.from_numpy(hot).to(dev), 1024,
                          f"hot segment (90% of rows) n={m} S=1024 d={d}")
            segment_check(torch, segment_reduce, vals,
                          torch.zeros(m, dtype=torch.int32, device=dev), 1,
                          f"one segment n={m} S=1 d={d}")
            cases += 2
        if dtype == "float64":
            # phase 2d: a shard's aggregate after the exchange (2.5M rows
            # of the 20M into that shard's ~250,000 of 2M groups)
            m = 2_500_000
            vals = torch.from_numpy(rng.random((m, 1))).to(dev, tdt)
            tid = torch.from_numpy(rng.integers(0, 250_000, m)).to(
                dev, torch.int32)
            segment_check(torch, segment_reduce, vals, tid, 250_000,
                          "shuffle shard n=2.5M S=250,000")
            cases += 1
        if dtype != "bfloat16":
            big_n, big_s = 1 << 22, 1 << 27
            assert segment_reduce.plan_sort(big_n, 1, big_s, 8).passes == 4
            vals = torch.from_numpy(rng.random((big_n, 1)) + 0.5).to(dev, tdt)
            tid = torch.from_numpy(rng.integers(-1, big_s, big_n)).to(dev)
            segment_check(torch, segment_reduce, vals, tid, big_s,
                          "n=2^22 S=2^27 (4 sort passes)")
            cases += 1
        empty = segment_reduce.segment_sum_cuda(
            torch.empty((0, 3), dtype=tdt, device=dev),
            torch.empty((0,), dtype=torch.int32, device=dev), 7)
        assert empty.shape == (7, 3) and not bool(empty.float().any())
        cases += 1
    # the public wrapper flattens trailing dims and restores them
    vals = torch.from_numpy(rng.random((1000, 2, 3))).to(dev)
    tid = torch.from_numpy(rng.integers(-1, 9, 1000)).to(dev)
    got = segment_reduce.segment_sum(vals, tid, 9)
    assert tuple(got.shape) == (9, 2, 3)
    torch.testing.assert_close(
        got, segment_reduce.segment_sum_reference(vals, tid, 9),
        rtol=1e-12, atol=0.0)
    return {"cases": cases + 1}


def time_segment_sum(np, torch, segment_reduce, n, d, s, dtype, flush,
                     reps=20) -> dict:
    """Kernel, plain version and one ``index_add_`` at one main-path shape:
    values [n, d] of ``dtype``, int32 ids over ``s`` segments (the engine's
    per-block call), all ids valid as in ``aggregate``. The kernel is first
    held against the plain version on these inputs (widened to f64, as in
    :func:`phase_kernel_checks`) and against a second run of itself."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.random((n, d))).to(dev, dtype)
    ids = torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(dev)
    kern = segment_reduce.segment_sum_cuda(vals, ids, s)
    again = segment_reduce.segment_sum_cuda(vals, ids, s)
    plain = segment_reduce.segment_sum_reference(vals.double(), ids, s)
    name = str(dtype).replace("torch.", "")
    assert torch.equal(kern.view(torch.uint8), again.view(torch.uint8)), \
        f"not bit-identical at the main path's shape: {name} [{n}, {d}] S={s}"
    torch.testing.assert_close(
        kern.double(), plain, rtol=KERNEL_RTOL[name], atol=0.0,
        msg=lambda m: f"{name} [{n}, {d}] S={s}: {m}")
    err = float((kern.double() - plain).abs().max())
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    lib_out = torch.zeros((s, d), dtype=acc, device=dev)
    lib_vals = vals.to(acc)

    def library():
        lib_out.index_add_(0, ids, lib_vals)

    ms = time_ms(torch, lambda: segment_reduce.segment_sum_cuda(vals, ids, s),
                 reps, flush)
    plain_ms = time_ms(torch, lambda: segment_reduce.segment_sum_reference(
        vals, ids, s), reps, flush)
    library_ms = time_ms(torch, library, reps, flush)
    item = vals.element_size()
    nbytes = n * (d * item + ids.element_size()) + s * d * item
    return {"shape": {"rows": n, "width": d, "segments": s, "dtype": name,
                      "ids": "int32"},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "library_ms": library_ms,
            "library": "torch.Tensor.index_add_ into a zeroed "
                       "accumulation-dtype output"}


def random_lm_params(np, cfg, seed: int) -> dict:
    """Transformer weights in the JAX package's pytree layout and scale
    (``TransformerLM.init``: normal times ``sqrt(1/fan_in)``, ``embed``
    also times ``sqrt(d_model)``), drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    D, H, Dh, F, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.vocab_size)

    def dense(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(np.sqrt(1.0 / fan_in))

    ones = np.ones((D,), np.float32)
    E = cfg.num_experts
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": ones, "wq": dense((D, H, Dh), D),
              "wk": dense((D, H, Dh), D), "wv": dense((D, H, Dh), D),
              "wo": dense((H, Dh, D), D), "ln2": ones}
        if E > 0:  # a Switch MoE layer (router f32, experts [E, ...])
            lp["moe"] = {"router": dense((D, E), D),
                         "w1": dense((E, D, F), D),
                         "w2": dense((E, F, D), F)}
        else:
            lp.update(w1=dense((D, F), D), w2=dense((F, D), F))
        layers.append(lp)
    return {"embed": dense((V, D), D) * np.float32(np.sqrt(D)),
            "layers": layers, "ln_f": ones, "head": dense((D, V), D)}


# the backward's three kernels (csrc/flash_attention_backward.cu)
FLASH_BACKWARD_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def device_breakdown(torch, fn, top=6) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    its wall time up to a synchronize, the device's busy time (the kernels'
    and copies' summed time on the one stream), the idle share, the device
    time of the ``top`` kernels by name, and the backward kernels' time
    and count."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler also lists each record_function span that covers
    # kernels as a device event of the span's name: those are left out,
    # or the kernels under a span would count twice
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    spans = {e.key for e in events if e.device_type != cuda}
    kernels = [e for e in events
               if e.device_type == cuda and e.key not in spans]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    assert busy > 0, "the profiler saw no device time"
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total * 1e-3
                               for e in kernels[:top]},
            "flash_attention_ms": sum(
                e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) * 1e-3,
            "flash_backward_ms": sum(
                e.self_device_time_total for e in kernels
                if any(n in e.key for n in FLASH_BACKWARD_KERNELS)) * 1e-3,
            "flash_backward_kernels_ms": {
                n: sum(e.self_device_time_total for e in kernels
                       if n in e.key) * 1e-3
                for n in FLASH_BACKWARD_KERNELS},
            "flash_backward_kernel_counts": {
                n: sum(e.count for e in kernels if n in e.key)
                for n in FLASH_BACKWARD_KERNELS}}


def ptxas_report(log: str, names) -> dict:
    """Registers and spilled bytes of each instantiation of the kernels
    ``names`` in ``log``, the output of an ``nvcc -Xptxas -v`` build:
    ``{"dkdv_kernel<float32,64>": {"registers": r, "spill_stores": s,
    "spill_loads": l}}``, read from the mangled names' template arguments
    (the type, then the head dim padded up)."""
    import re

    types = {"f": "float32", "13__nv_bfloat16": "bfloat16",
             "6__half": "float16"}
    pattern = re.compile(r"\d(%s)I(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?"
                         % "|".join(names))
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = pattern.search(m.group(1))
            entry = None if k is None else "%s<%s%s>" % (
                k.group(1), types[k.group(2)],
                "," + k.group(3) if k.group(3) else "")
            if entry:
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def phase_transformer_score(np, torch, fa, models, state, batch=8, seq=2048,
                            seed=6, cfg=None) -> dict:
    """Full-width scoring on the card: ``apply`` five times (once under the
    profiler) and ``loss`` once over [batch, seq] tokens, each forward
    launching the flash kernel once per layer; then sequence 0's logits and
    loss against the same weights on the CPU (plain attention) to rtol/atol
    1e-4: f32 products summed in other orders by cuBLAS, the kernel and the
    CPU, through 6 layers."""
    cfg = cfg or models.TransformerConfig()
    params = random_lm_params(np, cfg, seed)
    t0 = time.perf_counter()
    model = state["model"] = models.TransformerLM(cfg)
    model.load_state_dict(models.params_from_jax(params))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq))).to(model.device)
    targets = torch.roll(tokens, -1, dims=1)
    torch.cuda.reset_peak_memory_stats()

    def forward(fn):
        before = fa.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = fa.launches - before
        assert got == cfg.n_layers, \
            f"a forward launched flash_attention {got} times, not {cfg.n_layers}"
        return out, wall

    with torch.no_grad():
        logits, first_s = forward(lambda: model.apply(tokens))
        assert tuple(logits.shape) == (batch, seq, cfg.vocab_size), \
            logits.shape
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        walls = [forward(lambda: model.apply(tokens))[1] for _ in range(3)]
        profiled, _ = forward(lambda: device_breakdown(
            torch, lambda: model.apply(tokens)))
        loss, loss_s = forward(lambda: model.loss(tokens, targets))
        loss = float(loss)
        peak = torch.cuda.max_memory_allocated()

        cpu = models.TransformerLM(cfg, device="cpu")
        cpu.load_state_dict(models.params_from_jax(params))
        t0 = time.perf_counter()
        ref = cpu.apply(tokens[:1].cpu())
        cpu_s = time.perf_counter() - t0
        ref_loss = float(cpu._xent(ref, targets[:1].cpu()))
        got = logits[:1].cpu()
        got_loss = float(model._xent(logits[:1], targets[:1]))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        assert abs(got_loss - ref_loss) <= 1e-4 * abs(ref_loss), \
            (got_loss, ref_loss)
    assert np.isfinite(loss)
    wall = sum(walls) / len(walls)
    return {"config": {"vocab": cfg.vocab_size, "d_model": cfg.d_model,
                       "heads": cfg.n_heads, "layers": cfg.n_layers,
                       "d_ff": cfg.d_ff, "dtype": str(cfg.dtype)},
            "params": sum(p.numel() for p in model.parameters()),
            "tokens": [batch, seq], "load_weights_wall_s": load_s,
            "first_forward_wall_s": first_s, "forward_wall_s": wall,
            "forward_walls_s": walls, "tokens_per_s": batch * seq / wall,
            "loss_wall_s": loss_s, "loss": loss,
            "max_memory_allocated_bytes": peak,
            "cpu_reference_wall_s": cpu_s,
            "seq0_logits_max_abs_err": float((got - ref).abs().max()),
            "seq0_loss": got_loss, "seq0_loss_cpu": ref_loss,
            "forward_profile": profiled}


def phase_generate_via_frame(ttf, np, torch, state, n=16, s0=128, new=16,
                             parts=2, seed=8) -> dict:
    """Greedy decoding through the frame engine, bit-equal to ``generate``
    on each block's prompts (the same batches); a sampled run twice from
    one seed gives the same tokens."""
    model = state["model"]
    rng = np.random.default_rng(seed)
    vocab = model.config.vocab_size
    prompts = rng.integers(0, vocab, (n, s0))  # int64 cells, as users hold
    df = ttf.analyze(ttf.frame({"prompt": prompts}, num_partitions=parts))

    def completions(**kw):
        out = model.generate_via_frame(df, max_new_tokens=new, **kw)
        blocks = [b.columns["completion"] for b in out.blocks()]
        return out, blocks

    t0 = time.perf_counter()
    out, blocks = completions()
    frame_s = time.perf_counter() - t0
    comp = np.concatenate(blocks)
    field = out.schema["completion"]
    assert field.dtype.name == "int" and comp.dtype == np.int32, field
    assert comp.shape == (n, s0 + new), comp.shape
    np.testing.assert_array_equal(comp[:, :s0], prompts)
    t0, row = time.perf_counter(), 0
    for blk in blocks:
        direct = model.generate(
            torch.from_numpy(prompts[row:row + len(blk)]).to(model.device),
            new)
        np.testing.assert_array_equal(blk, direct.cpu().numpy())
        row += len(blk)
    direct_s = time.perf_counter() - t0

    sampled = [np.concatenate(completions(
        temperature=1.0, rng=torch.Generator().manual_seed(7))[1])
        for _ in range(2)]
    np.testing.assert_array_equal(sampled[0], sampled[1])
    assert ((sampled[0] >= 0) & (sampled[0] < vocab)).all()
    np.testing.assert_array_equal(sampled[0][:, :s0], prompts)
    assert not np.array_equal(sampled[0][:, s0:], comp[:, s0:]), \
        "sampling at temperature 1 gave the greedy tokens"
    return {"prompts": n, "prompt_len": s0, "new_tokens": new,
            "partitions": parts, "generate_via_frame_wall_s": frame_s,
            "generate_direct_wall_s": direct_s,
            "new_tokens_per_s": n * new / frame_s}


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for a
    block: the embedding's backward (an accumulating ``index_put_``) then
    sums in a fixed order (cuBLAS only warns: its products on one stream
    repeat bit for bit)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def phase_transformer_train(np, torch, fa, fab, models, ckpt, batch=8,
                            seq=2048, seed=6, steps=5, lr=1e-3,
                            cfg=None) -> dict:
    """The adam train step at full width (``TransformerConfig()``, f32)
    over [batch, seq] tokens, weights from a numpy seed. Step 0 is taken
    as ``step`` takes it (``loss_and_grads`` then ``adam_update``), its
    gradients held against the same weights' gradients through the plain
    attention on the card to 1e-4 of each parameter's max-abs; then
    ``steps`` timed steps through ``step`` on the same batch, each
    launching the flash forward and backward once per layer, the loss
    falling; one more under the profiler. The state is saved to
    ``build/``, restored into a fresh ``init_state()``, and one step from
    it equals the uninterrupted run's next step bit for bit (under
    :func:`deterministic`, both)."""
    import shutil
    from unittest import mock

    from tensorframes_tpu_torch.models import transformer as tr

    cfg = cfg or models.TransformerConfig()
    model = models.TransformerLM(cfg)
    step, init_state = model.make_sharded_train_step(learning_rate=lr)
    state = init_state(models.params_from_jax(random_lm_params(np, cfg,
                                                               seed)))
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq))).to(model.device)
    targets = torch.roll(tokens, -1, dims=1)

    def counted(fn):
        before = (fa.launches, fab.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (fa.launches - before[0], fab.launches - before[1])
        assert got == (cfg.n_layers, cfg.n_layers), \
            f"a step launched (forward, backward) {got}, not {cfg.n_layers}"
        return out, wall

    # step 0: the kernels' gradients against the plain attention's
    with mock.patch.object(tr, "flash_attention",
                           fa.flash_attention_reference):
        _, plain = model.loss_and_grads(state["params"], tokens, targets)
    torch.cuda.synchronize()
    (loss0, grads), first_s = counted(
        lambda: model.loss_and_grads(state["params"], tokens, targets))
    worst = 0.0
    for name, want in plain.items():
        top = float(want.abs().max())
        err = float((grads[name] - want).abs().max())
        assert err <= 1e-4 * top, (name, err, top)
        worst = max(worst, err / top)
    del plain
    tr.adam_update(state["params"], grads, state["opt"], lr)
    del grads
    losses = [float(loss0)]
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(steps):
        (state, loss), wall = counted(lambda: step(state, tokens, targets))
        losses.append(float(loss))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    profiled, _ = counted(lambda: device_breakdown(
        torch, lambda: step(state, tokens, targets)))
    done = steps + 2

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save_step(root, done, state)
    save_s = time.perf_counter() - t0
    with deterministic(torch):
        state, loss_a = step(state, tokens, targets)
        t0 = time.perf_counter()
        restored, at = ckpt.restore_step(root, init_state())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert at == done and int(restored["opt"]["count"]) == done
        restored, loss_b = step(restored, tokens, targets)
        torch.cuda.synchronize()
    assert torch.equal(loss_a, loss_b), (float(loss_a), float(loss_b))
    for name, p in state["params"].items():
        assert torch.equal(restored["params"][name], p), name
    shutil.rmtree(root, ignore_errors=True)
    wall = sum(walls) / len(walls)
    busy = profiled["device_busy_s"]
    return {"config": {"vocab": cfg.vocab_size, "d_model": cfg.d_model,
                       "heads": cfg.n_heads, "layers": cfg.n_layers,
                       "d_ff": cfg.d_ff, "dtype": str(cfg.dtype)},
            "tokens": [batch, seq], "learning_rate": lr,
            "losses": losses, "step0_wall_s": first_s, "step_walls_s": walls,
            "step_wall_s": wall, "tokens_per_s": batch * seq / wall,
            "max_memory_allocated_bytes": peak,
            "step0_grad_max_rel_err": worst,
            "backward_share_of_device": profiled["flash_backward_ms"] * 1e-3
            / busy, "forward_share_of_device":
            profiled["flash_attention_ms"] * 1e-3 / busy,
            "step_profile": profiled, "checkpoint_save_s": save_s,
            "checkpoint_restore_s": restore_s,
            "resumed_step_bit_equal": True}


def phase_train_lm_demo(np, torch) -> dict:
    """The ported ``train_lm`` demo's ``main`` on the card: 30 steps with
    a checkpoint every 10 under ``build/``, a "crash", a resume from step
    30 to 40; the loss at step 40 below a tenth of step 1's, and the
    trained model continuing a +1 sequence."""
    import shutil

    from tensorframes_tpu_torch.demos import train_lm

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_lm_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    out = train_lm.main(checkpoint_root=root)
    shutil.rmtree(root, ignore_errors=True)
    assert out["resumed_from"] == 30 and len(out["losses"]) == 40, out
    assert out["final_loss"] < out["first_loss"] / 10, out
    assert all(np.isfinite(out["losses"]))
    return {"first_loss": out["first_loss"], "final_loss": out["final_loss"],
            "resumed_from": out["resumed_from"],
            "continuation": out["continuation"]}


def phase_resnet50_infer(ttf, np, torch, models, n=256, parts=8, size=224,
                         seed=12) -> dict:
    """BASELINE config 4: ``n`` seeded NHWC images (f32) in ``parts``
    partitions through ``ResNet50.infer_via_frame`` (weights from a seed),
    once cold and once timed; logits ``[n, 1000]``, finite, and image 0's
    within 1e-4 of their max-abs of the same weights on the CPU (f32
    convolutions in other orders and algorithms, TF32 off)."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    model = models.ResNet50(generator=torch.Generator().manual_seed(seed))
    df = ttf.frame({"image": imgs}, num_partitions=parts)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = model.infer_via_frame(df).blocks()
        torch.cuda.synchronize()
        return blocks, time.perf_counter() - t0

    _, cold_s = run()
    blocks, wall = run()
    logits = np.concatenate([b.dense("logits") for b in blocks])
    assert logits.shape == (n, 1000) and logits.dtype == np.float32, \
        logits.shape
    assert np.isfinite(logits).all()
    cpu = models.ResNet50(device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ref = cpu.apply(torch.from_numpy(imgs[:1]))[0].numpy()
    err = float(np.abs(logits[0] - ref).max())
    assert err <= 1e-4 * float(np.abs(ref).max()), (err, np.abs(ref).max())
    return {"images": n, "image": [size, size, 3], "partitions": parts,
            "cold_wall_s": cold_s, "timed_wall_s": wall, "block_wall_s":
            wall / parts, "images_per_s": n / wall,
            "image0_max_abs_err": err,
            "image0_logits_max_abs": float(np.abs(ref).max())}


def phase_logreg(ttf, np, torch, models, n=262_144, d=64, parts=8, seed=13,
                 steps=10) -> dict:
    """BASELINE config 5: ``n`` x ``d`` f32 features in ``parts``
    partitions, labels drawn from the logistic model of a seeded true
    ``w``. ``gradient_via_frame`` at the model's initial parameters
    against numpy in f64 on the same f32 rows: rtol 1e-5 (f32 products and
    sums over 32,768-row blocks), with an absolute floor of 1e-6 of the
    largest component for components near zero; then ``fit_via_frame``
    for ``steps`` steps, the loss falling; one more step under the
    profiler gives the card's busy and idle share of a step."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    w_true = rng.standard_normal(d) / np.sqrt(d) * 4.0
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(x @ w_true)))) \
        .astype(np.float32)
    df = ttf.frame({"features": x, "label": y}, num_partitions=parts)
    model = models.LogisticRegression(d)
    params = {k: v.cpu().numpy() for k, v in model.init().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad, loss = model.gradient_via_frame(params, df)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    xd = x.astype(np.float64)
    z = xd @ params["w"].astype(np.float64) + float(params["b"])
    err = 1.0 / (1.0 + np.exp(-z)) - y
    want_w = xd.T @ err / n
    want_b = err.mean()
    nll = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    floor = 1e-6 * np.abs(want_w).max()
    np.testing.assert_allclose(grad["w"], want_w, rtol=1e-5, atol=floor)
    np.testing.assert_allclose(grad["b"], want_b, rtol=1e-5, atol=floor)
    assert abs(loss - nll.mean()) <= 1e-5 * nll.mean(), (loss, nll.mean())
    t0 = time.perf_counter()
    _, losses = model.fit_via_frame(df, steps=steps, lr=1.0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profiled = device_breakdown(
        torch, lambda: model.fit_via_frame(df, steps=1, lr=1.0))
    return {"rows": n, "features": d, "partitions": parts,
            "gradient_wall_s": grad_s, "fit_steps": steps,
            "fit_wall_s": fit_s, "step_wall_s": fit_s / steps,
            "one_step_breakdown": profiled, "losses": losses,
            "grad_w_max_rel_err": float(np.max(
                np.abs(grad["w"] - want_w) / np.abs(want_w).max())),
            "loss_numpy_f64": float(nll.mean())}


def card_mesh(np, torch, ttf_parallel, shape, names, device):
    """A ``DeviceMesh`` of ``prod(shape)`` logical shards of ``device``."""
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = [device] * n
    return ttf_parallel.DeviceMesh(devs.reshape(shape), names,
                                   data_axis=names[0])


def wall_steps(torch, step, state, tokens, targets, n):
    """``n`` steps of ``step`` on one batch, each timed to a
    synchronize: ``(state, losses, walls)``."""
    losses, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens, targets)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    return state, losses, walls


def grads_close(np, got, want) -> float:
    """The worst of each gradient's max abs error over its reference's
    max-abs; raises past 1e-4."""
    worst = 0.0
    for name, w in want.items():
        top = float(w.abs().max())
        err = float((got[name].to(w.device) - w).abs().max())
        assert err <= 1e-4 * top, (name, err, top)
        worst = max(worst, err / top)
    return worst


def phase_transformer_mesh(np, torch, fa, fab, models, batch=8, seq=2048,
                           seed=6, steps=3, lr=1e-3, cfg=None,
                           moe_cfg=None, logreg_rows=262_144,
                           logreg_features=64, demo_steps=(30, 40, 10),
                           ring_elems=1 << 20, device="cuda") -> dict:
    """The transformer on meshes of logical shards of the card, at the
    width of phases 4 and 5b (``TransformerConfig()``, f32, weights from a
    numpy seed through ``params_from_jax``, [batch, seq] tokens):

    (a) ``ring_attention`` over a 4-shard seq axis at [8, 2048, 8, 64] f32,
        causal against B2 and non-causal against the plain attention, to
        1e-5 of the output's max-abs, both timed beside B2 on the same
        inputs; ``ring_allreduce`` of [8, ``ring_elems``] f32 on 8 shards
        against the sum to rtol 1e-6 (positive values: no cancellation);
        each call's ``collective`` event and hops on the query trace;
    (b) ``make_sharded_train_step(learning_rate=lr)`` on (data 8), (data 2,
        model 4) and (data 2, model 2, seq 2): step 0's loss to 1e-5
        relative of the one-device step's on the same state, its gathered
        gradients to 1e-4 of each parameter's max-abs, then ``steps`` timed
        steps, the loss falling, B2 forward and backward launched once per
        layer and (data, model) shard a step (none with the seq axis);
    (c) ``TransformerConfig(num_experts=8)`` on (data 2, model 2, expert
        2) against its one-device step: step 0's loss (with aux) to 1e-5
        relative, the dropped tokens' count equal, at capacity factor 0.5
        too, where layer 0's tokens through ``switch_ffn`` on a (data 2,
        expert 2) mesh drop the same tokens as on one shard; ``steps``
        steps, the loss falling;
    (d) ``make_pipelined_train_step`` on (data 2, pipe 3), 2 layers a
        stage, 4 microbatches: step 0's loss to 1e-5 relative of the
        one-device step's, ``steps`` steps, the loss falling;
    (e) logistic regression at BASELINE config 5's ``logreg_rows`` x
        ``logreg_features`` f32 on (data 8) against the one-device step
        (3 steps): losses to 1e-6 relative, parameters to 1e-6 of the
        largest one's magnitude;
    (f) the ``train_lm`` demo on (data 2, model 4): ``demo_steps[0]``
        steps checkpointing every ``demo_steps[2]``, a resume to
        ``demo_steps[1]``, the resumed losses equal to an uninterrupted
        run's (``tests/test_demos.py``'s bound, rtol 1e-4, atol 1e-5).

    ``device="cpu"`` rehearses the phase at a small size (``cfg``,
    ``moe_cfg`` and the sizes given; ``time_ms`` and the ``torch.cuda``
    memory calls stubbed by the caller). Returns each part's numbers (also printed as one JSON line a part) and
    ``compare_launches``: B2's launches that only served as a reference in
    (a), which the ``kernels`` line leaves out."""
    import shutil

    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.demos import train_lm
    from tensorframes_tpu_torch.parallel import moe
    from tensorframes_tpu_torch.utils.tracing import counters

    cfg = cfg or models.TransformerConfig()
    moe_cfg = moe_cfg or models.TransformerConfig(num_experts=8)
    out = {}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(256 << 20 if dev.type == "cuda" else 1,
                        dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)

    def part(name, info):
        emit({"phase": "transformer_mesh_8x2048", "part": name, **info})
        out[name] = info

    def launches(fn):
        before = (fa.launches, fab.launches)
        result = fn()
        torch.cuda.synchronize()
        return result, (fa.launches - before[0], fab.launches - before[1])

    # (a) the ring
    t0 = time.perf_counter()
    H, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (batch, seq, H, Dh), dtype=np.float32)).to(dev) for _ in range(3))
    ring4 = card_mesh(np, torch, parallel, (4,), ("seq",), dev)
    with obs.query_trace("ring") as trace:
        causal = parallel.ring_attention(q, k, v, ring4, causal=True)
        full = parallel.ring_attention(q, k, v, ring4, causal=False)
        x = torch.from_numpy(rng.uniform(
            size=(8, ring_elems)).astype(np.float32)).to(dev)
        reduced = parallel.ring_allreduce(
            x, card_mesh(np, torch, parallel, (8,), ("data",), dev))
    events = [(e.name, e.args) for e in trace.events
              if e.etype == "collective"]
    assert [n for n, _ in events] == ["ring_attention", "ring_attention",
                                      "ring_allreduce"], events
    assert [a["hops"] for _, a in events] == [8, 8, 14], events
    b2, compare = launches(lambda: fa.flash_attention(q, k, v, causal=True))
    compare_fa = compare[0]
    err_c = float((causal - b2).abs().max())
    assert err_c <= 1e-5 * float(b2.abs().max()), (err_c, b2.abs().max())
    plain = fa.flash_attention_reference(q, k, v, False)
    err_f = float((full - plain).abs().max())
    assert err_f <= 1e-5 * float(plain.abs().max()), (err_f,)
    want = x.sum(dim=0)
    torch.testing.assert_close(reduced, want.expand_as(x), rtol=1e-6,
                               atol=0)
    del plain, full, reduced, want
    ring_ms = time_ms(torch, lambda: parallel.ring_attention(
        q, k, v, ring4, causal=True), 3, flush)
    b2_ms, compare = launches(lambda: time_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), 3, flush))
    compare_fa += compare[0]
    del q, k, v, x, causal, b2
    part("a_ring", {"shape": [batch, seq, H, Dh], "seq_shards": 4,
                    "causal_max_abs_err_vs_b2": err_c,
                    "full_max_abs_err_vs_plain": err_f,
                    "allreduce": [8, ring_elems],
                    "collectives": [{"name": n, **a} for n, a in events],
                    "ring_ms": ring_ms, "b2_ms": b2_ms,
                    "wall_s": time.perf_counter() - t0})

    # the one-device step: the reference of (b), (d) and its wall
    params = models.params_from_jax(random_lm_params(np, cfg, seed))
    model = models.TransformerLM(cfg, device=dev)
    one_step, one_init = model.make_sharded_train_step(learning_rate=lr)
    state = one_init(params)
    (loss_1, grads_1), _ = launches(lambda: model.loss_and_grads(
        state["params"], tokens, targets))
    loss_1 = float(loss_1)
    torch.cuda.reset_peak_memory_stats()
    state, one_losses, one_walls = wall_steps(torch, one_step, state, tokens,
                                              targets, steps)
    one_peak = torch.cuda.max_memory_allocated()
    del state

    # (b) dense layouts
    t0 = time.perf_counter()
    layouts = []
    for names, shape, seq_axis in ((("data",), (8,), None),
                                   (("data", "model"), (2, 4), None),
                                   (("data", "model", "seq"), (2, 2, 2),
                                    "seq")):
        mesh = card_mesh(np, torch, parallel, shape, names, dev)
        step, init_state = model.make_sharded_train_step(
            mesh, seq_axis=seq_axis, learning_rate=lr)
        st = init_state(params)
        (loss0, grads), counts0 = launches(lambda: step.loss_and_grads(
            st, tokens, targets))
        assert abs(float(loss0) - loss_1) <= 1e-5 * abs(loss_1), \
            (names, float(loss0), loss_1)
        worst = grads_close(np, grads, grads_1)
        del grads
        torch.cuda.reset_peak_memory_stats()
        (st, losses, walls), counts = launches(lambda: wall_steps(
            torch, step, st, tokens, targets, steps))
        peak = torch.cuda.max_memory_allocated()
        shards = shape[0] * (shape[1] if "model" in names else 1)
        per_step = 0 if seq_axis else cfg.n_layers * shards
        assert counts0 == (per_step, per_step), (names, counts0)
        assert counts == (steps * per_step,) * 2, (names, counts)
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert abs(losses[0] - loss_1) <= 1e-5 * abs(loss_1), losses
        layouts.append({"mesh": dict(zip(names, shape)),
                        "step0_loss": float(loss0), "losses": losses,
                        "step_walls_s": walls,
                        "step_wall_s": sum(walls[1:]) / (steps - 1),
                        "step0_grad_max_rel_err": worst,
                        "b2_per_step": per_step,
                        "b2_launches": counts[0] + counts0[0],
                        "b2_backward_launches": counts[1] + counts0[1],
                        "max_memory_allocated_bytes": peak})
        del st, step, init_state
        torch.cuda.empty_cache()
    del grads_1
    part("b_dense", {"one_device": {"step0_loss": loss_1,
                                    "losses": one_losses,
                                    "step_walls_s": one_walls,
                                    "step_wall_s": sum(one_walls[1:])
                                    / (steps - 1),
                                    "max_memory_allocated_bytes": one_peak},
                     "layouts": layouts,
                     "wall_s": time.perf_counter() - t0})

    # (c) the Switch MoE
    t0 = time.perf_counter()
    moe_params = models.params_from_jax(random_lm_params(np, moe_cfg, seed))
    mesh = card_mesh(np, torch, parallel, (2, 2, 2),
                     ("data", "model", "expert"), dev)
    moe_info = {}
    for factor in (moe_cfg.expert_capacity_factor, 0.5):
        c = dataclasses.replace(moe_cfg, expert_capacity_factor=factor)
        lm = models.TransformerLM(c, device=dev)
        one, one_init = lm.make_sharded_train_step(learning_rate=lr)
        dropped = counters.get("moe.dropped_tokens")
        st = one_init(moe_params)
        one_loss = float(lm.loss_and_grads(st["params"], tokens,
                                           targets)[0])
        one_dropped = counters.get("moe.dropped_tokens") - dropped
        step, init_state = lm.make_sharded_train_step(
            mesh, expert_axis="expert", learning_rate=lr)
        mst = init_state(moe_params)
        dropped = counters.get("moe.dropped_tokens")
        (loss0, _), counts0 = launches(lambda: step.loss_and_grads(
            mst, tokens, targets))
        mesh_dropped = counters.get("moe.dropped_tokens") - dropped
        assert abs(float(loss0) - one_loss) <= 1e-5 * abs(one_loss), \
            (factor, float(loss0), one_loss)
        assert mesh_dropped == one_dropped, (factor, mesh_dropped,
                                             one_dropped)
        info = {"step0_loss": float(loss0), "one_device_loss": one_loss,
                "dropped_tokens": mesh_dropped,
                "b2_per_step": counts0[0]}
        assert counts0 == (c.n_layers * 4,) * 2, counts0
        if factor == moe_cfg.expert_capacity_factor:
            st, one_losses, one_walls = wall_steps(torch, one, st, tokens,
                                                   targets, steps)
            torch.cuda.reset_peak_memory_stats()
            (mst, losses, walls), counts = launches(lambda: wall_steps(
                torch, step, mst, tokens, targets, steps))
            assert counts == (steps * c.n_layers * 4,) * 2, counts
            assert all(np.isfinite(losses)) and losses[-1] < losses[0], \
                losses
            info.update(losses=losses, step_walls_s=walls,
                        step_wall_s=sum(walls[1:]) / (steps - 1),
                        one_device_step_walls_s=one_walls,
                        one_device_step_wall_s=sum(one_walls[1:])
                        / (steps - 1),
                        max_memory_allocated_bytes=
                        torch.cuda.max_memory_allocated())
        else:
            # layer 0's Switch FFN on random activations: the same tokens
            # dropped on one shard and on a (data 2, expert 2) mesh
            assert mesh_dropped > 0, "capacity factor 0.5 dropped nothing"
            lp = moe_params
            w = {n: lp[f"layers.0.moe.{n}"].to(dev)
                 for n in ("router", "w1", "w2")}
            h = torch.from_numpy(rng.standard_normal(
                (batch * seq, c.d_model), dtype=np.float32)).to(dev)
            y1, aux1 = moe.switch_ffn(h, w, capacity_factor=factor)
            y2, aux2 = moe.switch_ffn(
                h, w, capacity_factor=factor,
                mesh=card_mesh(np, torch, parallel, (2, 2),
                               ("data", "expert"), dev),
                expert_axis="expert")
            drop1 = (y1 == 0).all(dim=1)
            assert torch.equal(drop1, (y2 == 0).all(dim=1))
            torch.testing.assert_close(y2, y1, rtol=1e-5, atol=1e-5)
            assert abs(float(aux1) - float(aux2)) <= 1e-6 * float(aux1)
            info["layer0_switch_dropped"] = int(drop1.sum())
            del h, y1, y2
        moe_info[str(factor)] = info
        del st, mst, step, one, lm
        torch.cuda.empty_cache()
    part("c_moe", {"mesh": {"data": 2, "model": 2, "expert": 2},
                   "experts": moe_cfg.num_experts, "by_capacity_factor":
                   moe_info, "wall_s": time.perf_counter() - t0})

    # (d) the GPipe pipeline
    t0 = time.perf_counter()
    mesh = card_mesh(np, torch, parallel, (2, 3), ("data", "pipe"), dev)
    step, init_state = model.make_pipelined_train_step(
        mesh, num_microbatches=4, learning_rate=lr)
    st = init_state(params)
    torch.cuda.reset_peak_memory_stats()
    (st, losses, walls), counts = launches(lambda: wall_steps(
        torch, step, st, tokens, targets, steps))
    assert abs(losses[0] - loss_1) <= 1e-5 * abs(loss_1), (losses, loss_1)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    per_step = 4 * 2 * cfg.n_layers  # microbatches x data shards x layers
    assert counts == (steps * per_step,) * 2, counts
    part("d_pipeline", {"mesh": {"data": 2, "pipe": 3},
                        "layers_a_stage": cfg.n_layers // 3,
                        "microbatches": 4, "losses": losses,
                        "step_walls_s": walls,
                        "step_wall_s": sum(walls[1:]) / (steps - 1),
                        "one_device_step_wall_s": sum(one_walls[1:])
                        / (steps - 1),
                        "b2_per_step": per_step,
                        "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated(),
                        "wall_s": time.perf_counter() - t0})
    del st, step, init_state, params, model
    torch.cuda.empty_cache()

    # (e) logistic regression on a data mesh
    t0 = time.perf_counter()
    lrng = np.random.default_rng(13)
    n, d = logreg_rows, logreg_features
    x = torch.from_numpy(lrng.standard_normal((n, d), dtype=np.float32))
    w_true = lrng.standard_normal(d) / np.sqrt(d) * 4.0
    y = torch.from_numpy((lrng.uniform(size=n) < 1.0 / (1.0 + np.exp(
        -(x.numpy() @ w_true)))).astype(np.float32))
    x, y = x.to(dev), y.to(dev)
    lreg = models.LogisticRegression(d, device=dev)
    mstep = lreg.make_sharded_train_step(
        card_mesh(np, torch, parallel, (8,), ("data",), dev), lr=1.0)
    ostep = lreg.make_sharded_train_step(None, lr=1.0)
    mp = op = lreg.init()
    lwalls, owalls, lloss = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mp, ml = mstep(mp, x, y)
        torch.cuda.synchronize()
        lwalls.append(time.perf_counter() - t1)
        op, ol = ostep(op, x, y)
        torch.cuda.synchronize()
        owalls.append(time.perf_counter() - t1 - lwalls[-1])
        assert abs(float(ml) - float(ol)) <= 1e-6 * abs(float(ol)), (ml, ol)
        # to 1e-6 of the parameters' max-abs (b alone can be near 0)
        top = max(float(t.abs().max()) for t in op.values())
        for key in mp:
            err = float((mp[key] - op[key]).abs().max())
            assert err <= 1e-6 * top, (key, err, top)
        lloss.append(float(ml))
    assert lloss[-1] < lloss[0], lloss
    part("e_logreg", {"rows": n, "features": d, "mesh": {"data": 8},
                      "losses": lloss, "step_walls_s": lwalls,
                      "one_device_step_walls_s": owalls,
                      "wall_s": time.perf_counter() - t0})
    del x, y

    # (f) the train_lm demo on (data 2, model 4)
    t0 = time.perf_counter()
    mesh = card_mesh(np, torch, parallel, (2, 4), ("data", "model"), dev)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_lm_mesh_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    first, total, every = demo_steps
    (_, losses), counts = launches(lambda: train_lm.train(
        mesh, n_steps=first, checkpoint_root=root + "/a",
        checkpoint_every=every))
    _, more = train_lm.train(mesh, n_steps=total, checkpoint_root=root
                             + "/a", checkpoint_every=every, resume=True)
    _, whole = train_lm.train(mesh, n_steps=total, checkpoint_root=root
                              + "/b", checkpoint_every=10 * total)
    shutil.rmtree(root, ignore_errors=True)
    assert len(losses) == first and len(more) == total - first
    np.testing.assert_allclose(more, whole[first:], rtol=1e-4, atol=1e-5)
    assert whole[-1] < whole[0], (whole[0], whole[-1])
    assert counts[0] == counts[1] == first * 2 * 8, counts
    part("f_train_lm_demo", {"mesh": {"data": 2, "model": 4},
                             "first_loss": whole[0],
                             "final_loss": whole[-1],
                             "resumed_losses": more,
                             "wall_s": time.perf_counter() - t0})
    return {"compare_launches": {"flash_attention": compare_fa},
            "parts": sorted(out)}


# flash_attention against its f64 plain version: f32 to 2e-5 (the JAX
# tests' bound, tests/test_kernels.py): 3xTF32 products, about f32's own
# rounding, summed in another order; bf16 and f16 to 1e-2: exact 16-bit
# q.k products in f32, p split into two 16-bit halves (about 16 bits), then
# one rounding of the output to 8 (bf16) or 11 (f16) bits, 4e-3 relative
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 1e-2}


def flash_check(torch, fa, q, k, v, causal) -> float:
    """The kernel twice on the card (bit-identical) against the plain
    version on the same inputs widened to f64, to ``FLASH_TOL``. Returns
    the max abs error."""
    b, sq, h, d = q.shape
    name = str(q.dtype).replace("torch.", "")
    what = f"{name} causal={causal} B={b} Sq={sq} Sk={k.shape[1]} H={h} D={d}"
    got = fa.flash_attention_cuda(q, k, v, causal)
    again = fa.flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape, what
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8)), \
        f"not bit-identical: {what}"
    ref = fa.flash_attention_reference(q.double(), k.double(), v.double(),
                                       causal)
    tol = FLASH_TOL[name]
    torch.testing.assert_close(got.double(), ref, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return float((got.double() - ref).abs().max())


def phase_flash_checks(np, torch, fa) -> dict:
    rng = np.random.default_rng(9)
    bhs = ((1, 1), (2, 3), (1, 4), (3, 2))
    worst, cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).replace("torch.", "")
        for causal in (False, True):
            shapes = [(s, s, d) for s in (8, 21, 37, 1000, 2048)
                      for d in (8, 16, 64, 128)]
            shapes += [(24, 40, 8), (24, 40, 64), (1, 2048, 64),
                       (40, 24, 16)]
            for i, (sq, sk, d) in enumerate(shapes):
                b, h = bhs[i % len(bhs)]
                q, k, v = (torch.from_numpy(rng.standard_normal(
                    (b, s, h, d))).to("cuda", dtype) for s in (sq, sk, sk))
                err = flash_check(torch, fa, q, k, v, causal)
                worst[name] = max(worst.get(name, 0.0), err)
                cases += 1
    # the public entry point makes strided inputs contiguous for the kernel
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 33, 16)))
               .float().to("cuda").transpose(1, 2) for _ in range(3))
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, causal=True),
        fa.flash_attention_reference(q, k, v, causal=True),
        rtol=2e-5, atol=2e-5)
    return {"cases": cases + 1, "max_abs_err": worst}


# the backward against autograd of the plain version on the same inputs
# widened to f64, each cotangent's worst error over its reference's
# max-abs: f32 to 1e-4 (f32 products in another order, from the forward's
# 3xTF32 log-sum-exp), bf16 and f16 to 2e-2 (delta from the output rounded
# to 8 or 11 bits, one rounding of each gradient); a cotangent that is zero
# by symmetry (one key: the softmax is constant, dq = dk = 0 up to
# rounding) against the largest of the three. The log-sum-exp to 1e-5.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}


def flash_backward_check(torch, fa, fab, q, k, v, g, causal) -> dict:
    """The op's forward (with its log-sum-exp) and backward kernels twice
    on the card (bit-identical) against the f64 plain backward. Returns
    each cotangent's error over its scale, and the log-sum-exp's."""
    b, sq, h, d = q.shape
    name = str(q.dtype).replace("torch.", "")
    what = (f"{name} causal={causal} B={b} Sq={sq} Sk={k.shape[1]} H={h} "
            f"D={d} offset={q.storage_offset()}")

    def grads():
        out, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        return fab.flash_attention_backward_cuda(q, k, v, out, lse, g,
                                                 causal), lse

    (got, lse), (again, _) = grads(), grads()
    torch.cuda.synchronize()
    want = fab.flash_attention_backward_reference(
        q.double(), k.double(), v.double(), g.double(), causal)
    tops = [float(w.abs().max()) for w in want]
    errs = {}
    for c, x, y, w, top in zip(("dq", "dk", "dv"), got, again, want, tops):
        assert x.dtype == q.dtype and x.shape == w.shape, what
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), \
            f"not bit-identical: {c} {what}"
        scale = top if top > 1e-6 * max(tops) else max(tops)
        errs[c + "_abs"] = float((x.double() - w).abs().max())
        errs[c] = errs[c + "_abs"] / scale
        assert errs[c] <= FLASH_BWD_TOL[name], f"{c} {what}: {errs[c]}"
    _, ref = fa.flash_attention_reference(q.double(), k.double(), v.double(),
                                          causal, return_lse=True)
    errs["lse"] = float((lse.double() - ref).abs().max())
    assert errs["lse"] <= 1e-5 * max(1.0, float(ref.abs().max())), \
        f"lse {what}: {errs['lse']}"
    return errs


def misaligned(torch, x):
    """A contiguous copy of ``x`` whose data starts one element past the
    start of its storage, so not on a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y = y.view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def phase_flash_backward_checks(np, torch, fa, fab) -> dict:
    """dq, dk, dv and the log-sum-exp against the plain autograd on the
    card: (B, H) as in :func:`phase_flash_checks`; Sq and Sk in {1, 63, 64,
    65, 200, 2048}, equal and not; head dims 8, 16, 32, 64, 128 and 40
    (8 and 16 padded to 32 in shared memory); causal and not; f32, bf16 and
    f16; then the ``train_lm_demo`` phase's own shape, [16, 32, 8, 8]
    causal, in each dtype (435 cases). Then ``own_loader``: the cases whose
    tiles ``cp.async`` cannot take and the kernels' own loader copies, over
    the same lengths, causal and not, and dtypes: head dims 33 and 100
    (rows not a multiple of 16 bytes) and head dim 64 with every input
    :func:`misaligned` (216 cases)."""
    rng = np.random.default_rng(14)
    bhs = ((1, 1), (2, 3), (1, 4), (3, 2))
    lengths = [(s, s) for s in (1, 63, 64, 65, 200, 2048)]
    lengths += [(63, 65), (65, 63), (1, 200), (200, 1), (64, 2048),
                (2048, 200)]
    dtypes = (torch.float32, torch.bfloat16, torch.float16)

    def sweep(rng, dtype, dims, w, shift=lambda x: x):
        cases = 0
        for causal in (False, True):
            for i, (sq, sk) in enumerate(lengths):
                for j, d in enumerate(dims):
                    b, h = bhs[(i + j) % len(bhs)]
                    if max(sq, sk) == 2048:
                        b, h = 1, 2
                    q, k, v, g = (shift(torch.from_numpy(rng.standard_normal(
                        (b, s, h, d))).to("cuda", dtype))
                        for s in (sq, sk, sk, sq))
                    errs = flash_backward_check(torch, fa, fab, q, k, v, g,
                                                causal)
                    for c, e in errs.items():
                        w[c] = max(w.get(c, 0.0), e)
                    cases += 1
        return cases

    worst, cases = {}, 0
    for dtype in dtypes:
        name = str(dtype).replace("torch.", "")
        w = worst.setdefault(name, {})
        cases += sweep(rng, dtype, (8, 16, 32, 64, 128, 40), w)
        # the demo's attention: d_model 64 over 8 heads
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (16, 32, 8, 8))).to("cuda", dtype) for _ in range(4))
        demo = flash_backward_check(torch, fa, fab, q, k, v, g, True)
        for c, e in demo.items():
            w[c] = max(w.get(c, 0.0), e)
        cases += 1
        worst.setdefault("train_lm_demo_shape", {})[name] = {
            c: demo[c] for c in ("dq", "dk", "dv", "lse")}
    rng = np.random.default_rng(15)
    own, own_cases = {}, 0
    for dtype in dtypes:
        w = own.setdefault(str(dtype).replace("torch.", ""), {})
        own_cases += sweep(rng, dtype, (33, 100), w)
        own_cases += sweep(rng, dtype, (64,), w,
                           lambda x: misaligned(torch, x))
    return {"cases": cases, "max_err_over_scale": worst,
            "own_loader": {"cases": own_cases, "max_err_over_scale": own},
            "tolerance": FLASH_BWD_TOL}


def time_flash_backward(np, torch, fa, fab, dtype, flush, b=8, s=2048, h=8,
                        d=64, reps=10, profiled_calls=20) -> dict:
    """The backward kernels, the plain backward (autograd of the plain
    version) and ``scaled_dot_product_attention``'s backward by autograd,
    at the transformer's shape, causal: each the backward alone, its
    forward's graph built once. The kernels are first held against the f64
    plain backward on these inputs (:func:`flash_backward_check`). The
    bound: the five products of the gradients, 2 * d flops per kept
    (query, key) pair each, at the tensor cores' peak for the type (f32 as
    3xTF32), against reading q, k, v, o, dO and the log-sum-exp once and
    writing dq, dk, dv once. ``kernel_ms``: each of the three kernels'
    mean device time over ``profiled_calls`` more calls in one profile
    (:func:`device_breakdown`), and ``kernel_launches_recorded`` how many
    of each the profile saw: late in this script a profile can miss the
    first of its calls (PERF.md §7), and the mean is over those it saw."""
    import torch.nn.functional as F

    name = str(dtype).replace("torch.", "")
    rng = np.random.default_rng(15)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to("cuda", dtype) for _ in range(4))
    errs = flash_backward_check(torch, fa, fab, q, k, v, g, True)
    out, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True)
    ms = time_ms(torch, lambda: fab.flash_attention_backward_cuda(
        q, k, v, out, lse, g, True), reps, flush)
    flush.zero_()

    def profiled():
        for _ in range(profiled_calls):
            fab.flash_attention_backward_cuda(q, k, v, out, lse, g, True)

    split = device_breakdown(torch, profiled)
    recorded = split["flash_backward_kernel_counts"]
    kernel_ms = {n: t / recorded[n] if recorded[n] else None
                 for n, t in split["flash_backward_kernels_ms"].items()}

    def backward_of(forward, leaves, cot):
        o = forward(*leaves)
        return lambda: torch.autograd.grad(o, leaves, cot, retain_graph=True)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_ms = time_ms(torch, backward_of(
        lambda *a: fa.flash_attention_reference(*a, True), leaves, g),
        reps, flush)
    del leaves
    views = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    library_ms = time_ms(torch, backward_of(
        lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
        views, g.transpose(1, 2)), reps, flush)
    pairs = s * (s + 1) // 2  # top-left causal, Sq == Sk
    flops = 5 * 2 * d * pairs * b * h
    item = q.element_size()
    nbytes = 8 * b * s * h * d * item + b * h * s * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / HBM_BYTES_PER_S
    return {"shape": {"B": b, "S": s, "H": h, "D": d, "dtype": name,
                      "causal": True},
            "max_abs_err": max(errs[c + "_abs"] for c in ("dq", "dk", "dv")),
            "errors_over_scale": errs, "ms": ms, "kernel_ms": kernel_ms,
            "profiled_calls": profiled_calls,
            "kernel_launches_recorded": recorded,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "library_ms": library_ms,
            "library": "autograd backward of torch.nn.functional."
                       "scaled_dot_product_attention(is_causal=True) on "
                       "[B, H, S, D] tensors"}


def time_flash(np, torch, fa, dtype, flush, b=8, s=2048, h=8, d=64,
               reps=20) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at the
    transformer's shape, causal. The kernel is first held against the f64
    plain version and a second run of itself on these inputs (flash_check).
    The bound counts the score pairs the causal mask keeps, 4 * d flops
    each, at the tensor cores' peak for the type (f32 as 3xTF32)."""
    import torch.nn.functional as F

    name = str(dtype).replace("torch.", "")
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                    dtype=np.float32))
               .to("cuda", dtype) for _ in range(3))
    err = flash_check(torch, fa, q, k, v, True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D] views
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, True),
                 reps, flush)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, True), reps, flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps, flush)
    pairs = s * (s + 1) // 2  # top-left causal, Sq == Sk
    flops = 4 * d * pairs * b * h
    nbytes = 4 * b * s * h * d * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / HBM_BYTES_PER_S
    return {"shape": {"B": b, "S": s, "H": h, "D": d, "dtype": name,
                      "causal": True},
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True) on [B, H, S, D] views"}


def phase_timings(np, torch, segment_reduce, fa, fab=None) -> tuple:
    """Each kernel timed at its main paths' shapes: segment_sum on one
    block of phase 2 (f64, S = 100,000), of phase 3 (f32 x 64,
    S = 1,024), of phase 3b (a 1M-row row group, f64, S = 100,000) and of
    phase 3c (the roll-up's 750k rows into 7,000 groups, and Q2.1's block
    after its filter, about 6,000 rows into 280 groups, both f64), of
    phase 3d (2.5M rows of f32 ``z``, S = 100,000), of phase 3e's part
    (a) (20M rows of f32 ``z`` in one block, S = 100,000) and of phase
    3f's fold (a batch's views of one window, about 133,000 f64 ones, S =
    100 campaigns; phase 3g's 1M-row fold is phase 3b's shape) and of
    phase 3h's JL fold (250,000 f32 rows, S = 100,000; its reference fold
    is phase 2's shape) and of phase 3j's k-means variant B (a block's
    points, 250,000 x 64 f64, and its counts, 250,000 x 1 f64, S = 256)
    and of phase 3l: a block of the 80-partition etl query of part (c) and
    of the child's queries (250,000 f64 rows, S = 100,000), a block of
    part (d)'s whale (1M f32 rows, S = 100,000) and of the 200,000-row
    frame of parts (b) and (d) (50,000 f64 rows, S = its distinct keys)
    and of phase 3m's chaos drill (its aggregate's 1,024 f64 rows a block,
    S = 64; 3m's other shapes are 3l's) and of phase 2c (the 1-shard
    mesh's 20M f64 rows into 100,000 and 131,073 groups, the 8-shard
    mesh's 2.5M into 131,073 and into the two-key table's 32,769, the
    salted frame's 500,000 into 100,007; the 8-shard host route is phase
    2's shape) and of phase 3j's variant C (the gathered 2M x 64 and 2M x
    1 f64, S = 256) and of phase 2d's part (c) (a shard after the exchange,
    2.5M f64 rows into 250,000 groups; a shard of the dense route and the
    one-shard mesh, 2.5M and 20M rows into 2,000,000; the sketch route's
    scalar sum, 2.5M rows into 100) and of phase 2e (a surviving shard after
    a device loss, 2,857,143 f64 rows into 100,000 groups, and a shard of
    the rebalanced layout, 2,816,902 rows) and of phase 2f (a rank's
    shard, 2,750,000 f64 rows into 100,000, 131,073 and 32,769 groups; a
    shard of the one-rank world, 5M rows into 131,073; a shard of the
    analytics demo's kept rows, into its 65-slot table);
    flash_attention and its backward at the transformer's [8, 2048, 8,
    64] causal in f32 (the model's) and bf16 (the backward when ``fab``,
    its module, is given: an earlier checkout has none), then in f32 at
    phase 5f's per-shard shapes [1, 2048, 8, 64], [4, 2048, 2, 64] and
    [4, 2048, 4, 64]."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    # phase 3l's 200,000-row frame: the first rows of phase 2's keys
    small_s = int(np.unique(np.random.default_rng(2).integers(
        0, 100_000, 20_000_000)[:200_000]).size)
    shapes = [time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_000_000 // 8, 64,
                               1024, torch.float32, flush),
              time_segment_sum(np, torch, segment_reduce, 1_000_000, 1,
                               100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 6_000_000 // 8, 1,
                               7_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 6_000, 1, 280,
                               torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               100_000, torch.float32, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000, 1,
                               100_000, torch.float32, flush),
              time_segment_sum(np, torch, segment_reduce, 133_000, 1, 100,
                               torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_000_000 // 8, 1,
                               100_000, torch.float32, flush),
              time_segment_sum(np, torch, segment_reduce, 2_000_000 // 8, 64,
                               256, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_000_000 // 8, 1,
                               256, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 80,
                               1, 100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 8_000_000 // 8, 1,
                               100_000, torch.float32, flush),
              time_segment_sum(np, torch, segment_reduce, 200_000 // 4, 1,
                               small_s, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 4_096 // 4, 1, 64,
                               torch.float64, flush),
              # phase 2c: the 1-shard mesh's shard (host and device keys),
              # the 8-shard mesh's with device keys and two keys, and a
              # shard of the salted frame (100,000 keys + 7 salt slots)
              time_segment_sum(np, torch, segment_reduce, 20_000_000, 1,
                               100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000, 1,
                               131_073, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               131_073, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               32_769, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 4_000_000 // 8, 1,
                               100_007, torch.float64, flush),
              # phase 3j's variant C: the whole 2M-point array on one shard
              time_segment_sum(np, torch, segment_reduce, 2_000_000, 64, 256,
                               torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_000_000, 1, 256,
                               torch.float64, flush),
              # phase 2d (c): a shard's aggregate after the exchange, a
              # shard of the dense route (every group on every shard), the
              # one-shard mesh, and the sketch route's scalar sum
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               250_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               2_000_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000, 1,
                               2_000_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 20_000_000 // 8, 1,
                               100, torch.float64, flush),
              # phase 2e: a surviving shard after a device loss (20M rows
              # over 7 shards) and a shard of the rebalanced layout (its
              # padded rows; the slow shard holds 281,690 valid ones)
              time_segment_sum(np, torch, segment_reduce, -(-20_000_000 // 7),
                               1, 100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_816_902, 1,
                               100_000, torch.float64, flush),
              # phase 2f: a rank's shard (11M rows over 4, padded) with
              # host keys, device keys and the two-key table; a shard of
              # the one-rank world (20M over 4); a shard of the analytics
              # demo's kept rows over 8 (S = max_groups + 1)
              time_segment_sum(np, torch, segment_reduce, 2_750_000, 1,
                               100_000, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_750_000, 1,
                               131_073, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 2_750_000, 1,
                               32_769, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce, 5_000_000, 1,
                               131_073, torch.float64, flush),
              time_segment_sum(np, torch, segment_reduce,
                               -(-demo_kept_rows(np, 2_000_000) // 8), 1,
                               65, torch.float64, flush)]
    emit({"phase": "kernel_timing", "ok": True, "shapes": shapes})
    # B2 at the transformer's shape, then at the mesh steps' per-shard
    # shapes (f32, causal): (data 8) and a pipeline microbatch's data
    # shard [1, 2048, 8, 64], (data 2, model 4) [4, 2048, 2, 64],
    # (data 2, model 2, expert 2) [4, 2048, 4, 64]
    mesh_shapes = ((1, 8), (4, 2), (4, 4))
    flash_shapes = [time_flash(np, torch, fa, dt, flush)
                    for dt in (torch.float32, torch.bfloat16)] + [
        time_flash(np, torch, fa, torch.float32, flush, b=b, h=h)
        for b, h in mesh_shapes]
    emit({"phase": "flash_attention_timing", "ok": True,
          "shapes": flash_shapes})
    backward_shapes = [] if fab is None else [
        time_flash_backward(np, torch, fa, fab, dt, flush)
        for dt in (torch.float32, torch.bfloat16)] + [
        time_flash_backward(np, torch, fa, fab, torch.float32, flush, b=b,
                            h=h) for b, h in mesh_shapes]
    if backward_shapes:
        emit({"phase": "flash_attention_backward_timing", "ok": True,
              "shapes": backward_shapes})
    return shapes, flash_shapes, backward_shapes


def static_plan(phase, *args, **kwargs) -> dict:
    """Run a phase whose timed repeats and modelled counts are the static
    layout's: ``TFT_ADAPTIVE=0`` (no re-bucketed layout, no filter
    re-ordering) and ``TFT_RESULT_CACHE=0`` (a repeated forcing is not a
    cache hit) for the phase only, apart from its
    :func:`default_forcings`."""
    with env_scope(TFT_ADAPTIVE="0", TFT_RESULT_CACHE="0"):
        return phase(*args, **kwargs)


def print_card() -> None:
    print(smi_card(), flush=True)


def no_rebalance(run) -> dict:
    """``run()``, a phase of healthy mesh ops traced on equal shards of
    the card, whose shard times feed the skew tracker: it must leave
    every layout alone (``mesh.rebalances`` unmoved)."""
    from tensorframes_tpu_torch.utils.tracing import counters

    r0 = counters.get("mesh.rebalances")
    info = run()
    moved = counters.get("mesh.rebalances") - r0
    assert moved == 0, f"{moved} rebalance(s) on a healthy mesh"
    return info


def run_path(torch, phases, counters, per_phase=None) -> dict:
    """Run one main path's phases with every kernel's launch count set to
    0 just before and read just after; each phase reports its own counts
    and the engine's host spans (``per_phase``, when given, collects each
    phase's counts by name). Returns the path's counts."""
    from tensorframes_tpu_torch.utils import tracing

    for mod in counters.values():
        mod.launches = 0
    tracing.enable()
    for name, run in phases:
        tracing.timings.reset()
        t0 = time.perf_counter()
        before = {k: m.launches for k, m in counters.items()}
        info = run()
        torch.cuda.synchronize()
        launches = {k: m.launches - before[k] for k, m in counters.items()}
        if per_phase is not None:
            per_phase[name] = launches
        emit({"phase": name, "ok": True, "wall_s": time.perf_counter() - t0,
              "launches": launches, **info,
              "spans": tracing.timings.snapshot()})
    tracing.disable()
    return {k: m.launches for k, m in counters.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one GPU.")
    parser.add_argument(
        "--timings", metavar="ROOT",
        help="only build and time the kernels of the port checked out at "
             "ROOT")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        return 2
    if args.timings:
        sys.path.insert(0, os.path.abspath(args.timings))
    import numpy as np

    import tensorframes_tpu_torch as ttf
    from tensorframes_tpu_torch import models
    from tensorframes_tpu_torch.ops import _build, segment_reduce
    fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")
    try:  # an earlier checkout timed with --timings has no backward
        fab = importlib.import_module(
            "tensorframes_tpu_torch.ops.flash_attention_backward")
    except ImportError:
        if not args.timings:
            raise
        fab = None

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ttf.set_default_device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", file=sys.stderr)

    t0 = time.perf_counter()
    kernels = ("segment_sum", "flash_attention") + \
        (("flash_attention_backward",) if fab is not None else ())
    # the host runtime (g++) builds beside the kernels; an earlier
    # checkout timed with --timings has none
    host = () if args.timings else ("host_runtime",)
    _build.build(*kernels, *host)
    emit({"phase": "build", "ok": True, "kernels": list(kernels),
          "host": list(host),
          "port": os.path.dirname(os.path.abspath(ttf.__file__)),
          "wall_s": time.perf_counter() - t0,
          "ptxas": {  # an earlier checkout (--timings) keeps no logs
              "flash_attention": ptxas_report(
                  getattr(_build, "logs", {}).get("flash_attention", ""),
                  ("flash_fwd_kernel",)),
              "flash_attention_backward": ptxas_report(
                  getattr(_build, "logs", {}).get(
                      "flash_attention_backward", ""),
                  FLASH_BACKWARD_KERNELS)}})
    if args.timings:
        phase_timings(np, torch, segment_reduce, fa, fab)
        print_card()
        return 0

    # the main paths: each kernel's launches are counted from 0 around each
    counters = {"segment_sum": segment_reduce, "flash_attention": fa,
                "flash_attention_backward": fab}
    per_phase = {}
    shipped = {}  # the child process's launches (phase 3h)
    served = {}  # the child process's launches (phase 3l)
    ranks = {}  # the cluster's rank processes' launches (phase 2f)
    frame_path = run_path(torch, (
        ("readme_x_plus_3", lambda: phase_readme(ttf, np)),
        ("reference_workload_20M",
         lambda: phase_reference_workload(ttf, np, torch)),
        ("native_host_20M", lambda: phase_native_host(ttf, np, torch)),
        ("mesh_reference_workload_20M",
         lambda: no_rebalance(lambda: phase_mesh_reference_workload(
             ttf, np, torch, segment_reduce))),
        ("shuffle_20M",
         lambda: no_rebalance(lambda: phase_shuffle(ttf, np, torch,
                                                    segment_reduce))),
        ("elastic_20M",
         lambda: phase_elastic(ttf, np, torch, segment_reduce)),
        ("cluster_2x4_20M",
         lambda: phase_cluster(ttf, np, torch, segment_reduce, out=ranks)),
        ("kmeans_centre_update_2Mx64", lambda: phase_kmeans(ttf, np)),
        ("plan_parquet_20M",
         lambda: static_plan(phase_plan_parquet, ttf, np, torch,
                             segment_reduce)),
        ("ssb_q21_sf1",
         lambda: static_plan(phase_ssb_q21, ttf, np, torch,
                             segment_reduce)),
        ("oom_recovery_rff_20M",
         lambda: phase_oom_recovery_rff(ttf, np, torch, segment_reduce)),
        ("memory_budget_20M",
         lambda: static_plan(phase_memory_budget, ttf, np, torch,
                             segment_reduce)),
        ("stream_ysb_20M",
         lambda: phase_stream_ysb(ttf, np, torch, segment_reduce)),
        ("stream_windows_parquet_20M",
         lambda: phase_stream_windows_parquet(ttf, np, torch,
                                              segment_reduce)),
        ("shipped_computation_20M",
         lambda: phase_shipped_computation(ttf, np, torch, segment_reduce,
                                           out=shipped)),
        ("aggregate_fold_20M", lambda: phase_aggregate_fold(ttf, np, torch)),
        ("kmeans_demo_2M",
         lambda: phase_kmeans_demo(ttf, np, torch, segment_reduce)),
        ("adaptive_20M", lambda: phase_adaptive(ttf, np, torch)),
        ("serve_three_tenants_20M",
         lambda: phase_serve_three_tenants(ttf, np, torch, segment_reduce,
                                           out=served)),
        ("fabric_three_workers_20M",
         lambda: phase_fabric_three_workers(ttf, np, torch, segment_reduce,
                                            served))),
        counters, per_phase)
    assert frame_path["segment_sum"] > 0, \
        "aggregate never launched segment_sum"
    assert shipped["child_launches"] > 0, \
        "the shipped programs' process never launched segment_sum"
    for name in ("stream_ysb_20M", "stream_windows_parquet_20M"):
        assert per_phase[name]["segment_sum"] > 0, \
            f"the stream's fold never launched segment_sum in {name}"
    assert per_phase["kmeans_demo_2M"]["segment_sum"] == 48 + 6 + 9, \
        "k-means variants B-D did not launch segment_sum as modelled"
    assert per_phase["mesh_reference_workload_20M"]["segment_sum"] == \
        2 * (1 + 8) * 4, "the mesh did not launch segment_sum on every shard"
    assert per_phase["shuffle_20M"]["segment_sum"] > 0, \
        "the shuffle's aggregates never launched segment_sum"
    assert per_phase["elastic_20M"]["segment_sum"] > 0, \
        "the elastic mesh's aggregates never launched segment_sum"
    assert per_phase["cluster_2x4_20M"]["segment_sum"] == 8 and \
        ranks["child_launches"] >= 2 * 3 * 4 + 4, \
        "the cluster's ranks or the analytics demo did not launch " \
        "segment_sum on every shard"
    assert per_phase["serve_three_tenants_20M"]["segment_sum"] > 0 and \
        served["child_launches"] > 0, \
        "the served aggregates never launched segment_sum"
    assert per_phase["fabric_three_workers_20M"]["segment_sum"] > 0, \
        "the fabric's aggregates never launched segment_sum"
    state = {}
    lm_path = run_path(torch, (
        ("transformer_score_8x2048",
         lambda: phase_transformer_score(np, torch, fa, models, state)),
        ("transformer_generate_via_frame",
         lambda: phase_generate_via_frame(ttf, np, torch, state))),
        counters)
    assert lm_path["flash_attention"] > 0, \
        "the transformer never launched flash_attention"
    assert lm_path["flash_attention_backward"] == 0, \
        "scoring and decoding launched the backward"
    del state

    from tensorframes_tpu_torch.utils import checkpoint as ckpt
    per_phase = {}
    train_path = run_path(torch, (
        ("transformer_train_8x2048",
         lambda: phase_transformer_train(np, torch, fa, fab, models, ckpt)),
        ("train_lm_demo", lambda: phase_train_lm_demo(np, torch)),
        ("resnet50_infer_b32",
         lambda: phase_resnet50_infer(ttf, np, torch, models)),
        ("logreg_262kx64", lambda: phase_logreg(ttf, np, torch, models))),
        counters, per_phase)
    for name in ("transformer_train_8x2048", "train_lm_demo"):
        got = per_phase[name]
        assert got["flash_attention"] > 0 and \
            got["flash_attention_backward"] > 0, \
            f"{name} did not launch the flash forward and backward: {got}"

    mesh = {}

    def run_mesh():
        mesh.update(phase_transformer_mesh(np, torch, fa, fab, models))
        return mesh

    mesh_path = run_path(torch, (("transformer_mesh_8x2048", run_mesh),),
                         counters)
    mesh_fa = mesh_path["flash_attention"] \
        - mesh["compare_launches"]["flash_attention"]
    assert mesh_fa > 0 and mesh_path["flash_attention_backward"] > 0, \
        f"the mesh steps did not launch the flash forward and backward: " \
        f"{mesh_path}"

    t0 = time.perf_counter()
    info = phase_kernel_checks(np, torch, segment_reduce)
    emit({"phase": "kernel_vs_plain", "ok": True,
          "wall_s": time.perf_counter() - t0, **info})
    t0 = time.perf_counter()
    info = phase_flash_checks(np, torch, fa)
    emit({"phase": "flash_attention_vs_plain", "ok": True,
          "wall_s": time.perf_counter() - t0, **info})
    t0 = time.perf_counter()
    info = phase_flash_backward_checks(np, torch, fa, fab)
    emit({"phase": "flash_backward_vs_plain", "ok": True,
          "wall_s": time.perf_counter() - t0, **info})

    shapes, flash_shapes, backward_shapes = phase_timings(
        np, torch, segment_reduce, fa, fab)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "segment_sum", "route": "cuda",
         "source": "tensorframes_tpu_torch/csrc/segment_sum.cu",
         "replaces": "tensorframes_tpu/ops/segment_reduce.py:75",
         "launches": frame_path["segment_sum"] + shipped["child_launches"]
         + served["child_launches"] + ranks["child_launches"],
         **{k: shapes[0][k] for k in keys},
         "at": shapes[0]["shape"], "by_shape": shapes},
        {"name": "flash_attention", "route": "cuda",
         "source": "tensorframes_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tensorframes_tpu/ops/flash_attention.py:122",
         "launches": lm_path["flash_attention"]
         + train_path["flash_attention"] + mesh_fa,
         **{k: flash_shapes[0][k] for k in keys},
         "at": flash_shapes[0]["shape"], "by_shape": flash_shapes},
        {"name": "flash_attention_backward", "route": "cuda",
         "source": "tensorframes_tpu_torch/csrc/flash_attention_backward.cu",
         "replaces": None,
         "note": "the JAX package has no backward kernel: it differentiates "
                 "its plain attention (tensorframes_tpu/ops/"
                 "flash_attention.py:148-157, _xla_attention) with XLA's "
                 "autodiff",
         "launches": train_path["flash_attention_backward"]
         + mesh_path["flash_attention_backward"],
         **{k: backward_shapes[0][k] for k in keys},
         "at": backward_shapes[0]["shape"], "by_shape": backward_shapes}]})

    print_card()

    assert "jax" not in sys.modules and not any(
        m == "tensorframes_tpu" or m.startswith("tensorframes_tpu.")
        for m in sys.modules), "the port imported the JAX package"
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
