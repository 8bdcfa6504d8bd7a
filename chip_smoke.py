#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (exit code 1, no result line) where CUDA is not available or
the package is missing.  Phases, each fatal on failure:

1. **Build.**  Compiles every CUDA kernel of the serving path from
   ``mxnet_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a`` and prints the
   build time, the compiler's register report, and the card's name and
   power limit.
2. **Kernel vs plain.**  Calls each kernel's wrapper on the card at the
   serving path's largest shape, (B, H, T, D) = (8, 12, 512, 64), in
   bf16 and f32, for a ragged key-padding mask with one fully masked
   batch row, causal, an additive (H, T, T) bias, and dropout 0.1 with
   fixed seed words, and the mask and causal cases again at T = 305,
   off the kernel's tile grid; holds out and lse against the plain PyTorch
   version on the same inputs; times the kernel, the plain version and
   one library call of the same function (``scaled_dot_product_attention``,
   timed here only), beside the least time the card could take.
3. **Serving.**  BERT-base at full width (vocab 30522, units 768, FFN
   3072, 12 layers, 12 heads, max_length 512), random weights from a
   seed, cast to bf16 on ``cuda:0``, behind ``serve.Endpoint``
   (max_batch_size 8, sequence buckets 128/256/512): warmup, then 48
   requests of lengths spread over 1..512 from 4 client threads.  Every
   result must be finite and of its request's shape; the flash kernel's
   launch count over the served traffic must be 12 per dispatched batch;
   one result is checked against the same request run alone, and
   against the same model with ``use_flash=False``.
4. **Where the time goes.**  One forward at the largest and at the
   smallest bucket, timed back to back and traced with ``torch.profiler``:
   device time by kernel, and the share of the forward the card idles.

Every measurement is printed on a line of its own (``kernel``, ``serve:``,
``profile:``).  The last three lines are a ``{"kernels": [...]}`` object
(the flash kernel at the serving path's main case: bf16 with a
key-padding mask), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

# H100 SXM data sheet (dense): HBM bandwidth and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B, H, T, D = 8, 12, 512, 64
# A length off the 64-row tile grid: the kernel's last K and Q tiles are
# partial there (a request served alone runs at its own length)
T_RAGGED = 305
# Tolerances of kernel vs plain, |kernel - plain| <= atol + rtol |plain|
# for out, |kernel - plain| <= atol for lse.  f32: both are true f32 and
# differ only in summation order (online softmax by 64-key tiles vs
# whole rows).  bf16: both round out to bf16, so where their f32 values
# straddle a rounding step they differ by one bf16 ulp, 2^-8 to 2^-7 of
# the value (rtol 1e-2 covers it at every magnitude); and the kernel
# rounds p to bf16 against a running max, the plain version against the
# row max.  Typical outputs are 0.05-0.1 (randn v averaged over about
# 256 live keys; up to about 3 in rows with a few live keys), where the
# bound is about 3e-3.  lse is f32 in both (values of 5-10).
TOL = {"float32": {"out": (1e-4, 0.0), "lse": 1e-4},
       "bfloat16": {"out": (2e-3, 1e-2), "lse": 1e-4}}
CASES = [("ragged_mask", T), ("causal", T), ("bias", T), ("dropout", T),
         ("ragged_mask", T_RAGGED), ("causal", T_RAGGED)]
# BERT-base in bf16: one request served in a padded batch vs alone, and
# flash vs dense attention, as a relative L2 error over its valid rows
SERVE_REL_TOL = 2e-2
N_CLIENTS, PER_CLIENT = 4, 12


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn()`` on the card, by CUDA events over ``iters``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build("flash_attention_fwd")
    seconds = time.perf_counter() - t0
    ptxas = _build.BUILD_LOG.get("flash_attention_fwd", {}).get("ptxas", "")
    regs = sorted({line.split("Used ")[1].split(",")[0]
                   for line in ptxas.splitlines() if "Used " in line})
    log(f"build: {path.name} in {seconds:.1f} s (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}); ptxas: {'; '.join(regs)}")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------
def _attention_inputs(dtype, case, t, gen, dev):
    import torch
    q, k, v = (torch.randn(B, H, t, D, generator=gen).to(dev, dtype)
               for _ in range(3))
    kw = {}
    if case == "ragged_mask":
        lens = torch.randint(1, t + 1, (B,), generator=gen)
        lens[0] = 0                      # one fully masked batch row
        lens[1] = t
        kw["mask"] = (torch.arange(t)[None, :] < lens[:, None]).to(
            dev, torch.int32)
    elif case == "causal":
        kw["causal"] = True
    elif case == "bias":
        kw["bias"] = torch.randn(H, t, t, generator=gen).to(dev)
    elif case == "dropout":
        kw["dropout"] = 0.1
        kw["key"] = (0x1234ABCD, 0x9876)
    return q, k, v, kw


def _bound(dtype, kw, t, nbytes_elem):
    """Least time (ms) for the work these inputs need: every input the
    function needs read once and every output written once over the
    memory rate, and the products (4 * D flops per (query, attended key)
    pair) over the peak rate for the type.  With a key-padding mask only
    the valid keys' k and v rows are needed, and only they are
    attended."""
    qo = 2 * B * H * t * D * nbytes_elem + B * H * t * 4   # q, out, lse
    if "mask" in kw:
        n_valid = int(kw["mask"].sum().item())          # over batch rows
        io = qo + 2 * n_valid * H * D * nbytes_elem + B * t * 4
        keys = n_valid * H * t
    else:
        io = qo + 2 * B * H * t * D * nbytes_elem
        keys = B * H * t * (t + 1) // 2 if kw.get("causal") else B * H * t * t
    if "bias" in kw:
        io += kw["bias"].numel() * 4
    flops = 4 * D * keys
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _sdpa_call(q, k, v, kw):
    """One PyTorch call computing the same function (timing yardstick)."""
    import torch
    import torch.nn.functional as F
    if "mask" in kw:
        m = kw["mask"].bool()[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)
    if kw.get("causal"):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    if "bias" in kw:
        bias = kw["bias"].to(q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=kw["dropout"])


def phase_kernel_vs_plain(dev):
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(1234)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for case, t in CASES:
            q, k, v, kw = _attention_inputs(dtype, case, t, gen, dev)
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            diff = (out.float() - ref_out.float()).abs()
            err_out = diff.max().item()
            atol, rtol = TOL[dname]["out"]
            # worst error over its allowance; <= 1 passes
            err_ratio = (diff / (atol + rtol * ref_out.float().abs())
                         ).max().item()
            live = ref_lse > fa._MASKED_ROW
            err_lse = (lse - ref_lse)[live].abs().max().item()
            ok = (err_ratio <= 1.0 and err_lse <= TOL[dname]["lse"] and
                  bool(torch.isfinite(out).all()))
            if "mask" in kw:
                ok = ok and bool((out[0] == 0).all()) and \
                    bool((lse[0] < fa._MASKED_ROW).all())
            ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, **kw))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, **kw), iters=5)
            library_ms = cuda_ms(_sdpa_call(q, k, v, kw))
            bound_ms, bound_by = _bound(dname, kw, t, q.element_size())
            row = {"dtype": dname, "case": case, "shape": [B, H, t, D],
                   "max_abs_err": err_out, "err_over_tol": err_ratio,
                   "lse_max_abs_err": err_lse,
                   "tol": TOL[dname], "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "ok": ok}
            rows.append(row)
            log(f"kernel {dname:8s} {case:11s} T={t:<4d} "
                f"out_err={err_out:.3e} ({err_ratio:.2f} of tol) "
                f"lse_err={err_lse:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"{'ok' if ok else 'FAILED'}")
            del q, k, v, kw, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    failed = [f"{r['dtype']}/{r['case']}/T={r['shape'][2]}"
              for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: serving BERT-base through Endpoint
# ---------------------------------------------------------------------------
def make_requests(n, max_len, vocab, seed):
    """``n`` requests (tokens, segments, valid_mask), one row each, with
    lengths spread evenly over 1..max_len in shuffled order."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    lengths = rng.permutation(onp.linspace(1, max_len, n).astype(int))
    reqs = []
    for n_tok in lengths:
        tokens = rng.integers(1, vocab, (1, n_tok)).astype(onp.int32)
        segments = (onp.arange(n_tok) >= n_tok // 2).astype(onp.int32)[None]
        reqs.append((tokens, segments, onp.ones((1, n_tok), onp.int32)))
    return reqs


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def serve(net, dev, reqs, seq_buckets):
    """Serve ``reqs`` from N_CLIENTS threads through an Endpoint; returns
    (results, latencies_s, wall_s, stats, launches)."""
    from mxnet_tpu_torch.ops.flash_attention import FLASH_FWD
    from mxnet_tpu_torch.serve import Endpoint

    results = [None] * len(reqs)
    latencies = [None] * len(reqs)
    with Endpoint(net, device=dev, max_batch_size=8, max_latency_ms=5,
                  seq_buckets=seq_buckets) as ep:
        t0 = time.perf_counter()
        warmed = ep.warmup(*reqs[0])
        log(f"serve: warmup ran {warmed} bucket shapes in "
            f"{time.perf_counter() - t0:.2f} s")

        def client(idx):
            for i in idx:
                t_sub = time.perf_counter()
                results[i] = ep.submit(*reqs[i]).result(timeout=300)
                latencies[i] = time.perf_counter() - t_sub

        threads = [threading.Thread(
            target=client, args=(range(c, len(reqs), N_CLIENTS),))
            for c in range(N_CLIENTS)]
        FLASH_FWD.launches = 0           # count only the served traffic
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = FLASH_FWD.launches
        if any(th.is_alive() for th in threads):
            raise SystemExit("serving clients did not finish")
        stats = ep.stats()
    return results, latencies, wall, stats, launches


def phase_serve(dev, cfg=None, seq_buckets=(128, 256, 512),
                dtype="bfloat16"):
    import numpy as onp
    import torch
    from mxnet_tpu_torch.models import bert_base

    cfg = dict(cfg or {}, use_flash=True, dropout=0.1)
    n_layers = cfg.get("num_layers", 12)
    net = bert_base(**cfg).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast(dtype)
    vocab = net.word_embed._input_dim
    max_len = seq_buckets[-1]
    reqs = make_requests(N_CLIENTS * PER_CLIENT, max_len, vocab, seed=7)
    results, lat, wall, stats, launches = serve(net, dev, reqs, seq_buckets)

    for req, res in zip(reqs, results):
        seq, pooled = res
        n_tok = req[0].shape[1]
        if tuple(seq.shape) != (1, n_tok, cfg.get("units", 768)) or \
                not bool(torch.isfinite(seq).all()) or \
                not bool(torch.isfinite(pooled).all()):
            raise SystemExit(f"bad result for a request of length {n_tok}")
    if launches != n_layers * stats["batches"]:
        raise SystemExit(f"flash kernel launches {launches} != "
                         f"{n_layers} x {stats['batches']} batches")

    # one request padded inside its bucket, checked alone and against
    # dense attention
    i = min(range(len(reqs)),
            key=lambda j: abs(reqs[j][0].shape[1] - 0.6 * max_len))
    req = reqs[i]
    args = [torch.from_numpy(a).to(dev) for a in req]
    with torch.inference_mode():
        alone = net(*args)
        for blk in net.modules():
            if hasattr(blk, "_use_flash"):
                blk._use_flash = False
        dense = net(*args)
    err_alone = max(rel_err(a, b) for a, b in zip(results[i], alone))
    err_dense = max(rel_err(a, b) for a, b in zip(results[i], dense))
    ok = err_alone <= SERVE_REL_TOL and err_dense <= SERVE_REL_TOL
    n_tokens = sum(r[0].shape[1] for r in reqs)
    lat_ms = onp.sort(onp.asarray(lat) * 1e3)
    out = {
        "model": "bert_base", "dtype": dtype, "seq_buckets": list(seq_buckets),
        "requests": len(reqs), "clients": N_CLIENTS, "tokens": n_tokens,
        "wall_s": wall, "req_per_s": len(reqs) / wall,
        "tokens_per_s": n_tokens / wall,
        "latency_ms_p50": float(onp.percentile(lat_ms, 50)),
        "latency_ms_p99": float(onp.percentile(lat_ms, 99)),
        "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "execute_ms_p50": stats["execute_ms_p50"],
        "execute_ms_p99": stats["execute_ms_p99"],
        "cache_hits": stats["cache_hits"],
        "cache_misses": stats["cache_misses"],
        "flash_launches": launches,
        "checked_request_len": int(req[0].shape[1]),
        "rel_err_vs_alone": err_alone, "rel_err_vs_dense": err_dense,
        "rel_tol": SERVE_REL_TOL,
    }
    log("serve: " + json.dumps(out))
    if not ok:
        raise SystemExit("served result disagrees with the direct forward")
    return out, net


# ---------------------------------------------------------------------------
# phase 4: where one forward's time goes
# ---------------------------------------------------------------------------
def profile_forward(net, dev, rows, seq_len):
    """One forward at (rows, seq_len): its time back to back by CUDA
    events (bounded by the host when the host launches slower than the
    card runs), the device time a ``torch.profiler`` trace sums over
    kernels, the share of the forward the card was idle, and the ten
    largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab = net.word_embed._input_dim
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, vocab, (rows, seq_len), generator=gen).to(dev)
    segments = torch.zeros_like(tokens)
    valid = torch.ones_like(tokens)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: net(tokens, segments, valid), iters=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net(tokens, segments, valid)
            torch.cuda.synchronize()
    per_kernel = {}                  # device kernels only, not the ops
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        per_kernel[evt.key] = us / 1e3
        launches += evt.count
    total = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"shape": [rows, seq_len], "forward_ms": fwd_ms,
           "device_ms_traced": total if total else "not measured",
           "idle_share": (1 - total / fwd_ms) if total else "not measured",
           "kernel_launches": launches, "top_kernels_ms": top}
    log(f"profile: forward at ({rows}, {seq_len}): {fwd_ms:.3f} ms back to "
        f"back, {total:.3f} ms of it on the device in {launches} kernel "
        f"launches")
    for name, ms in top:
        log(f"profile:   {ms:9.3f} ms  {name[:90]}")
    return out


def phase_profile(net, dev):
    for blk in net.modules():
        if hasattr(blk, "_use_flash"):
            blk._use_flash = True
    return [profile_forward(net, dev, 8, 512),
            profile_forward(net, dev, 1, 128)]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the mxnet_tpu_torch package is missing ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = nvidia_smi()
    t_start = time.perf_counter()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    rows = phase_kernel_vs_plain(dev)
    served, net = phase_serve(dev)
    phase_profile(net, dev)
    del net
    log(f"seconds: {time.perf_counter() - t_start:.1f}")

    main_case = next(r for r in rows
                     if r["dtype"] == "bfloat16" and r["case"] == "ragged_mask"
                     and r["shape"][2] == T)
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:366",
        "launches": served["flash_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
