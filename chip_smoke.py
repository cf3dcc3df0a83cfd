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
4. the transformer LM at the JAX package's default width (vocab 32,000,
   d_model 512, 8 heads, 6 layers, d_ff 2,048, f32), weights from a numpy
   seed carried in through ``params_from_jax``: ``apply`` and ``loss`` over
   [8, 2048] tokens, 6 flash-attention launches per forward, one sequence
   held against the same model on the CPU with the plain attention;
5. ``generate_via_frame`` over 16 prompts of 128 tokens in 2 partitions,
   16 new tokens, greedy: bit-equal to ``generate`` on the same prompts; a
   sampled run reproduces itself;
6. each kernel against its plain PyTorch version on the card: segment_sum
   over dtypes, segment counts, widths, dropped ids, a hot segment with 90%
   of the rows and a single segment (also at the main path's 250k x 64
   block), 4 sort passes, an empty input and a ragged tail;
   flash_attention over f32/bf16/f16, causal or not, sequence lengths,
   Sq != Sk and head dims; each case twice for bit-identity. Then, at the
   main paths' shapes, each kernel held against the plain version and
   itself again and timed beside the plain version, one library call and
   its bound.

Each phase prints one JSON line. Then come a ``{"kernels": [...]}`` line
with each kernel's launches during its main path (phases 1-3e for
segment_sum, phase 4 for flash_attention), the card's name and power
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
import importlib
import json
import os
import subprocess
import sys
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


KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-2}


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
    layers = [{"ln1": ones, "wq": dense((D, H, Dh), D),
               "wk": dense((D, H, Dh), D), "wv": dense((D, H, Dh), D),
               "wo": dense((H, Dh, D), D), "ln2": ones,
               "w1": dense((D, F), D), "w2": dense((F, D), F)}
              for _ in range(cfg.n_layers)]
    return {"embed": dense((V, D), D) * np.float32(np.sqrt(D)),
            "layers": layers, "ln_f": ones, "head": dense((D, V), D)}


def device_breakdown(torch, fn, top=6) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    its wall time up to a synchronize, the device's busy time (the kernels'
    summed time on the one stream), the idle share, and the device time of
    the ``top`` kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    assert busy > 0, "the profiler saw no device time"
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total * 1e-3
                               for e in kernels[:top]},
            "flash_attention_ms": sum(
                e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) * 1e-3}


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


def phase_timings(np, torch, segment_reduce, fa) -> tuple:
    """Each kernel timed at its main paths' shapes: segment_sum on one
    block of phase 2 (f64, S = 100,000), of phase 3 (f32 x 64,
    S = 1,024), of phase 3b (a 1M-row row group, f64, S = 100,000) and of
    phase 3c (the roll-up's 750k rows into 7,000 groups, and Q2.1's block
    after its filter, about 6,000 rows into 280 groups, both f64), of
    phase 3d (2.5M rows of f32 ``z``, S = 100,000) and of phase 3e's part
    (a) (20M rows of f32 ``z`` in one block, S = 100,000),
    flash_attention at the transformer's [8, 2048, 8, 64] causal in f32
    (the model's) and bf16."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
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
                               100_000, torch.float32, flush)]
    emit({"phase": "kernel_timing", "ok": True, "shapes": shapes})
    flash_shapes = [time_flash(np, torch, fa, dt, flush)
                    for dt in (torch.float32, torch.bfloat16)]
    emit({"phase": "flash_attention_timing", "ok": True,
          "shapes": flash_shapes})
    return shapes, flash_shapes


def print_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def run_path(torch, phases, counters) -> dict:
    """Run one main path's phases with every kernel's launch count set to
    0 just before and read just after; each phase reports its own counts
    and the engine's host spans. Returns the path's counts."""
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
        emit({"phase": name, "ok": True, "wall_s": time.perf_counter() - t0,
              "launches": {k: m.launches - before[k]
                           for k, m in counters.items()},
              **info, "spans": tracing.timings.snapshot()})
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ttf.set_default_device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", file=sys.stderr)

    t0 = time.perf_counter()
    kernels = ("segment_sum", "flash_attention")
    _build.build(*kernels)
    emit({"phase": "build", "ok": True, "kernels": list(kernels),
          "port": os.path.dirname(os.path.abspath(ttf.__file__)),
          "wall_s": time.perf_counter() - t0})
    if args.timings:
        phase_timings(np, torch, segment_reduce, fa)
        print_card()
        return 0

    # the main paths: each kernel's launches are counted from 0 around each
    counters = {"segment_sum": segment_reduce, "flash_attention": fa}
    frame_path = run_path(torch, (
        ("readme_x_plus_3", lambda: phase_readme(ttf, np)),
        ("reference_workload_20M",
         lambda: phase_reference_workload(ttf, np, torch)),
        ("kmeans_centre_update_2Mx64", lambda: phase_kmeans(ttf, np)),
        ("plan_parquet_20M",
         lambda: phase_plan_parquet(ttf, np, torch, segment_reduce)),
        ("ssb_q21_sf1",
         lambda: phase_ssb_q21(ttf, np, torch, segment_reduce)),
        ("oom_recovery_rff_20M",
         lambda: phase_oom_recovery_rff(ttf, np, torch, segment_reduce)),
        ("memory_budget_20M",
         lambda: phase_memory_budget(ttf, np, torch, segment_reduce))),
        counters)
    assert frame_path["segment_sum"] > 0, \
        "aggregate never launched segment_sum"
    state = {}
    lm_path = run_path(torch, (
        ("transformer_score_8x2048",
         lambda: phase_transformer_score(np, torch, fa, models, state)),
        ("transformer_generate_via_frame",
         lambda: phase_generate_via_frame(ttf, np, torch, state))),
        counters)
    assert lm_path["flash_attention"] > 0, \
        "the transformer never launched flash_attention"
    del state

    t0 = time.perf_counter()
    info = phase_kernel_checks(np, torch, segment_reduce)
    emit({"phase": "kernel_vs_plain", "ok": True,
          "wall_s": time.perf_counter() - t0, **info})
    t0 = time.perf_counter()
    info = phase_flash_checks(np, torch, fa)
    emit({"phase": "flash_attention_vs_plain", "ok": True,
          "wall_s": time.perf_counter() - t0, **info})

    shapes, flash_shapes = phase_timings(np, torch, segment_reduce, fa)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "segment_sum", "route": "cuda",
         "source": "tensorframes_tpu_torch/csrc/segment_sum.cu",
         "replaces": "tensorframes_tpu/ops/segment_reduce.py:75",
         "launches": frame_path["segment_sum"],
         **{k: shapes[0][k] for k in keys},
         "at": shapes[0]["shape"], "by_shape": shapes},
        {"name": "flash_attention", "route": "cuda",
         "source": "tensorframes_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tensorframes_tpu/ops/flash_attention.py:122",
         "launches": lm_path["flash_attention"],
         **{k: flash_shapes[0][k] for k in keys},
         "at": flash_shapes[0]["shape"], "by_shape": flash_shapes}]})

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
