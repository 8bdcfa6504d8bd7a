#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (exit code 1, no result line) where CUDA is not available or
the package is missing.  Phases, each fatal on failure:

1. **Build.**  Compiles every CUDA kernel source in
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` each, all started together)
   for ``sm_90a`` and prints the build time, the compiler's register
   and spill report, and the card's name and power limit.
2. **Forward kernel vs plain.**  Calls B3's wrapper on the card at the
   serving path's largest shape, (B, H, T, D) = (8, 12, 512, 64), in
   bf16 and f32, for a ragged key-padding mask with one fully masked
   batch row, causal, an additive (H, T, T) bias, and dropout 0.1 with
   fixed seed words, and the mask and causal cases again at T = 305,
   off the kernel's tile grid; at the training path's shape (32, 12,
   128, 64) with the training batch's mask and dropout 0.1; and at the
   other head dims the kernels take (16, 32, 128) at (2, 3, 200, D) with
   every option at once.  Holds out and lse against the plain PyTorch
   version on the same inputs; times the kernel, the plain version and
   one library call of the same function
   (``scaled_dot_product_attention``, timed here only), beside the least
   time the card could take.
2b. **Backward kernels vs plain.**  B4 (dq) and B5 (dk, dv) on the same
   cases, and on mask, causal, bias and dropout alone at the training
   shape; held against the plain backward on the same saved forward and
   upstream gradient (and that forward, B3's out and lse, against the
   plain forward), with exact zeros required for the fully masked row's
   out and dq and for the dk/dv rows of padding keys; each kernel timed
   alone, beside its bound, the plain backward and SDPA's backward alone
   (``autograd.grad`` through one SDPA forward; its kernels' device time
   by ``torch.profiler``, two windows).
3. **Serving.**  BERT-base at full width (vocab 30522, units 768, FFN
   3072, 12 layers, 12 heads, max_length 512), random weights from a
   seed, cast to bf16 on ``cuda:0``, behind ``serve.Endpoint``
   (max_batch_size 8, sequence buckets 128/256/512): warmup, then 48
   requests of lengths spread over 1..512 from 4 client threads.  Every
   result must be finite and of its request's shape; the flash kernel's
   launch count over the served traffic must be 12 per dispatched batch;
   one result is checked against the same request run alone, and
   against the same model with ``use_flash=False``.
4. **Where a forward's time goes.**  One forward at the largest and at
   the smallest bucket, timed back to back and traced with
   ``torch.profiler``: device time by kernel, and the share the card
   idles.
3b. **Training.**  ``BertForPretraining`` at the same width, dropout 0.1,
   bf16, the repo's pretraining loss (masked MLM + NSP) on a fixed
   32 x 128 batch with ragged valid lengths, Adam at lr 1e-4 through
   ``Trainer`` and ``FusedTrainStep``: 3 warm-up steps, then 30 timed
   steps.  Every loss must be finite, the last five must average below
   the first, and each step must launch B3, B4 and B5 exactly 12 times.
   Then one eager ``record``/``backward``/``Trainer.step`` step against
   one fused step from the same state (within one bf16 ulp), and flash
   against dense gradients (2 layers, f32, dropout 0; relative L2 per
   parameter within 1e-3).
4b. **Where a training step's time goes.**  One step traced: device
   time, idle share, launches, top kernels, and the device-to-host
   syncs torch's sync debug mode reports.

Every measurement is printed on a line of its own (``kernel``,
``kernel_bwd``, ``serve:``, ``train:``, ``profile:``).  The last three
lines are a ``{"kernels": [...]}`` object (B3 at the serving path's
main case, bf16 with a key-padding mask, with its launches over the
served traffic; B4 and B5 at the training path's main case, with their
launches over the 30 timed steps), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
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
B_TRAIN, T_TRAIN = 32, 128
# Tolerances of kernel vs plain: |kernel - plain| <= atol + rtol |plain|
# + ptol A for out, A = sum_j p_j keep_j |v_j| / l (the plain forward on
# |v|), and |kernel - plain| <= atol for lse.  f32: both are true f32
# and differ only in summation order (online softmax by 64-key tiles vs
# whole rows).  bf16: both round each p * keep to bf16 before the PV
# product, the kernel against its running max and the plain version
# against the row max, so the two roundings of one term differ by up to
# two half-ulps, 2^-7 of it, and out's f32 values by up to 2^-7 A (ptol).
# A is about |out| where one key dominates but far larger where terms
# cancel (few live keys, large v: the training shape with dropout).
# Then both round out to bf16: one more ulp, at most 2^-7 |plain| (rtol).
# atol covers f32 summation order and the ulp of that ulp.  lse is f32 in
# both (values of 5-10).
TOL = {"float32": {"out": (1e-4, 0.0, 0.0), "lse": 1e-4},
       "bfloat16": {"out": (2e-4, 2.0 ** -7, 2.0 ** -7), "lse": 1e-4}}
# B4/B5 vs the plain backward, |kernel - plain| <= atol + rtol |plain| for
# dq, dk and dv.  f32: both true f32, summation order only; the plain f32
# backward differs from a float64 one by under 7e-7 at (1, 4, 512, 64)
# (gradients of 0.02-1), so atol 1e-5.  bf16: both round ds and p*keep to
# bf16 at the same points and the result to bf16, so where their f32
# values straddle a rounding step they differ by one bf16 ulp of the
# result (rtol 1e-2 covers it) or of one ds term (some 1e-5 of a sum;
# atol 1e-3 covers many).
BWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-3, 1e-2)}
# Kernel cases, (case, B, H, T, D): the serving path's largest shape, the
# same off the tile grid, the training path's shape with its own mask
# and dropout, and the other head dims the kernels take at a small shape
# off the grid with every option at once ("all")
_SERVE_CASES = [(c, B, H, T, D) for c in ("ragged_mask", "causal", "bias",
                                          "dropout")] \
    + [(c, B, H, T_RAGGED, D) for c in ("ragged_mask", "causal")]
_TRAIN_CASE = ("train_mask_dropout", B_TRAIN, H, T_TRAIN, D)
_HEAD_DIM_CASES = [("all", 2, 3, 200, d) for d in (16, 32, 128)]
CASES = _SERVE_CASES + [_TRAIN_CASE] + _HEAD_DIM_CASES
BWD_CASES = _SERVE_CASES \
    + [(c, B_TRAIN, H, T_TRAIN, D) for c in ("ragged_mask", "causal",
                                             "bias", "dropout")] \
    + [_TRAIN_CASE] + _HEAD_DIM_CASES
# BERT-base pretraining as `benchmark/bert_pretrain_bench.py` builds it
TRAIN_CFG = dict(vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 use_flash=True)
TRAIN_WARMUP, TRAIN_STEPS = 3, 30
# one bf16 ulp of a weight is at most 2^-7 of its magnitude
EAGER_FUSED_ULP = 2.0 ** -7
# flash vs dense gradients in f32 with TF32 off: both true f32, they
# differ in summation order and in the masked fill (-1e30 vs -1e9, both
# exp to exactly 0)
GRAD_REL_TOL = 1e-3
# BERT-base in bf16: one request served in a padded batch vs alone, and
# flash vs dense attention, as a relative L2 error over its valid rows
SERVE_REL_TOL = 2e-2
N_CLIENTS, PER_CLIENT = 4, 12
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


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
    """Build every kernel source, one nvcc for each, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    seconds = time.perf_counter() - t0
    for name, path in zip(SOURCES, paths):
        ptxas = _build.BUILD_LOG.get(name, {}).get("ptxas", "")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in ptxas.splitlines() if "Used " in line})
        spill = max((int(n) for n in re.findall(
            r"(\d+) bytes spill stores", ptxas)), default=0)
        log(f"build: {path.name} (nvcc {' '.join(_build.NVCC_FLAGS)}); "
            f"ptxas: {'; '.join(regs)}; most spill stores: {spill} bytes")
    log(f"build: {len(SOURCES)} sources in {seconds:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------
def _attention_inputs(dtype, case, shape, gen, dev):
    import torch
    b, h, t, d = shape
    q, k, v = (torch.randn(b, h, t, d, generator=gen).to(dev, dtype)
               for _ in range(3))
    kw = {}
    if case == "ragged_mask":
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0] = 0                      # one fully masked batch row
        lens[1] = t
        kw["mask"] = (torch.arange(t)[None, :] < lens[:, None]).to(
            dev, torch.int32)
    elif case == "causal":
        kw["causal"] = True
    elif case == "bias":
        kw["bias"] = torch.randn(h, t, t, generator=gen).to(dev)
    elif case == "dropout":
        kw["dropout"] = 0.1
        kw["key"] = (0x1234ABCD, 0x9876)
    elif case == "train_mask_dropout":
        # the training phase's batch: ragged lengths in [T/2, T] and
        # attention dropout 0.1
        kw["mask"] = torch.from_numpy(train_mask(b, t)).to(dev)
        kw["dropout"] = 0.1
        kw["key"] = (0x1234ABCD, 0x9876)
    elif case == "all":
        # a fully masked batch row and a ragged one, causal, a
        # (B, H, T, T) bias and dropout at once
        mask = torch.ones(b, t, dtype=torch.int32)
        mask[0] = 0
        mask[1, t * 3 // 4:] = 0
        kw = {"mask": mask.to(dev), "causal": True, "dropout": 0.1,
              "key": (77, 78),
              "bias": torch.randn(b, h, t, t, generator=gen).to(dev)}
    return q, k, v, kw


def _row0_masked(kw):
    """Whether batch row 0 has no valid key (its out and dq must be
    exact zeros)."""
    return "mask" in kw and not bool(kw["mask"][0].any())


def _live_pairs(kw, shape):
    """(query, key) pairs the mask and causal order leave."""
    import torch
    b, h, t, _ = shape
    keys = (kw["mask"].bool().cpu() if "mask" in kw
            else torch.ones(b, t, dtype=torch.bool))
    allowed = keys[:, None, :].expand(b, t, t)
    if kw.get("causal"):
        allowed = allowed & torch.ones(t, t, dtype=torch.bool).tril()
    return int(allowed.sum()) * h


def _key_bytes(kw, shape, nbytes_elem):
    """k and v bytes the function needs (only valid keys' rows under a
    mask), plus the mask and bias it reads."""
    b, h, t, d = shape
    rows = int(kw["mask"].sum().item()) if "mask" in kw else b * t
    io = 2 * rows * h * d * nbytes_elem
    if "mask" in kw:
        io += b * t * 4
    if "bias" in kw:
        io += kw["bias"].numel() * 4
    return io


def _bound(dtype, kw, shape, nbytes_elem):
    """Least time (ms) for the work these inputs need: every input the
    function needs read once and every output written once over the
    memory rate, and the products (4 * D flops per (query, attended key)
    pair) over the peak rate for the type.  With a key-padding mask only
    the valid keys' k and v rows are needed, and only they are
    attended."""
    b, h, t, d = shape
    qo = 2 * b * h * t * d * nbytes_elem + b * h * t * 4   # q, out, lse
    io = qo + _key_bytes(kw, shape, nbytes_elem)
    flops = 4 * d * _live_pairs(kw, shape)
    return _bound_ms(dtype, io, flops)


def _bound_ms(dtype, io, flops):
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _sdpa_call(q, k, v, kw):
    """One PyTorch call computing the same function, for timing only:
    SDPA with the key-padding mask, causal order and bias folded into its
    one ``attn_mask`` (its dropout draws other bits)."""
    import torch
    import torch.nn.functional as F
    t = q.shape[2]
    attn, causal = None, kw.get("causal", False)
    if "mask" in kw:
        attn = kw["mask"].bool()[:, None, None, :]
    if causal and (attn is not None or "bias" in kw):
        tril = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        attn = tril if attn is None else attn & tril
        causal = False
    if "bias" in kw:
        bias = kw["bias"].to(q.dtype)
        attn = bias if attn is None else bias.masked_fill(~attn,
                                                          float("-inf"))
    drop = kw.get("dropout", 0.0)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn, is_causal=causal, dropout_p=drop)


def _out_err(q, k, v, kw, out, ref_out, dname):
    """Max |kernel - plain| of B3's out, and the worst error over its
    allowance (<= 1 passes)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    atol, rtol, ptol = TOL[dname]["out"]
    allow = atol + rtol * ref_out.float().abs()
    if ptol:
        allow = allow + ptol * fa.flash_attention_reference(
            q, k, v.abs(), **kw)[0].float()
    diff = (out.float() - ref_out.float()).abs()
    return diff.max().item(), (diff / allow).max().item()


def _case_name(r):
    return f"{r['dtype']}/{r['case']}/{r['shape']}"


def phase_kernel_vs_plain(dev):
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(1234)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for case, *shape in CASES:
            q, k, v, kw = _attention_inputs(dtype, case, shape, gen, dev)
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            err_out, err_ratio = _out_err(q, k, v, kw, out, ref_out, dname)
            live = ref_lse > fa._MASKED_ROW
            err_lse = (lse - ref_lse)[live].abs().max().item()
            ok = (err_ratio <= 1.0 and err_lse <= TOL[dname]["lse"] and
                  bool(torch.isfinite(out).all()))
            if _row0_masked(kw):
                ok = ok and bool((out[0] == 0).all()) and \
                    bool((lse[0] < fa._MASKED_ROW).all())
            ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, **kw))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, **kw), iters=5)
            library_ms = cuda_ms(_sdpa_call(q, k, v, kw))
            bound_ms, bound_by = _bound(dname, kw, shape, q.element_size())
            row = {"dtype": dname, "case": case, "shape": shape,
                   "max_abs_err": err_out, "err_over_tol": err_ratio,
                   "lse_max_abs_err": err_lse,
                   "tol": TOL[dname], "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "ok": ok}
            rows.append(row)
            log(f"kernel {dname:8s} {case:18s} {tuple(shape)} "
                f"out_err={err_out:.3e} ({err_ratio:.2f} of tol) "
                f"lse_err={err_lse:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"{'ok' if ok else 'FAILED'}")
            del q, k, v, kw, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    failed = [_case_name(r) for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 2b: backward kernels vs plain
# ---------------------------------------------------------------------------
def train_mask(b, t):
    """The training batch's key-padding mask: valid prefixes of lengths
    ``RandomState(11).randint(t // 2, t + 1)``, as the repo's BERT
    pretraining benchmark draws them."""
    import numpy as onp
    lens = onp.random.RandomState(11).randint(t // 2, t + 1, size=b)
    return (onp.arange(t)[None, :] < lens[:, None]).astype(onp.int32)


def _bwd_bounds(dtype, kw, shape, nbytes_elem):
    """Least time (ms) of B4 and of B5 for these inputs.  Bytes: q, dO
    (and the k, v rows the mask leaves), lse and delta read once; dq, or
    dk and dv, written once.  Flops: 2 * D per live (query, key) pair for
    each product, 3 products in B4 (s, dp, dq) and 4 in B5 (s, dp, dv,
    dk)."""
    b, h, t, d = shape
    act = b * h * t * d * nbytes_elem          # one (B, H, T, D) tensor
    rows = b * h * t * 4                       # one (B, H, T) f32 tensor
    reads = 2 * act + 2 * rows + _key_bytes(kw, shape, nbytes_elem)
    pairs = _live_pairs(kw, shape)
    return (_bound_ms(dtype, reads + act, 3 * 2 * d * pairs),
            _bound_ms(dtype, reads + 2 * act, 4 * 2 * d * pairs))


def _sdpa_backward_ms(q, k, v, dout, kw):
    """SDPA's backward alone on the same inputs (timing yardstick only):
    its forward graph is built once with grad, then ``autograd.grad``
    through it runs in two windows of 20 calls, each timed by the card's
    kernel time (`device_ms`: the autograd engine's host work per call
    outlasts these kernels, so CUDA events would time the host), so
    their spread shows; and one window by CUDA events, to show it."""
    import torch
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = _sdpa_call(qg, kg, vg, kw)()

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dout,
                                   retain_graph=True)

    return device_ms(bwd), device_ms(bwd), cuda_ms(bwd)


def phase_bwd_vs_plain(dev):
    """B4 and B5 against `flash_attention_backward_reference` on the
    same saved forward and upstream gradient, and that forward (B3's out
    and lse) against `flash_attention_reference`."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(4321)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        atol, rtol = BWD_TOL[dname]
        for case, *shape in BWD_CASES:
            b, h, t, d = shape
            q, k, v, kw = _attention_inputs(dtype, case, shape, gen, dev)
            dout = torch.randn(*shape, generator=gen).to(dev, dtype)
            with torch.no_grad():
                out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            args = fa._LaunchArgs(q, kw.get("causal", False), d ** -0.5,
                                  kw.get("mask"), kw.get("bias"),
                                  kw.get("dropout", 0.0), kw.get("key"))
            delta = fa._delta(out, dout, None)
            dq = fa._launch_dq(q, k, v, dout, lse, delta, args)
            dk, dv = fa._launch_dkv(q, k, v, dout, lse, delta, args)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            _, fwd_ratio = _out_err(q, k, v, kw, out, ref_out, dname)
            live = ref_lse > fa._MASKED_ROW
            lse_err = (lse - ref_lse)[live].abs().max().item()
            plain = fa.flash_attention_backward_reference(
                q, k, v, out, lse, dout, **kw)
            errs, ratio = {}, 0.0
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
                diff = (got.float() - ref.float()).abs()
                errs[name] = diff.max().item()
                ratio = max(ratio, (diff / (atol + rtol * ref.float().abs())
                                    ).max().item())
            ok = (ratio <= 1.0 and fwd_ratio <= 1.0 and
                  lse_err <= TOL[dname]["lse"] and
                  all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv)))
            if "mask" in kw:
                dead = (kw["mask"] == 0)[:, None, :].expand(b, h, t)
                exact = (bool((dk[dead] == 0).all()) and
                         bool((dv[dead] == 0).all()))
                if _row0_masked(kw):             # batch row 0: no valid key
                    exact = exact and bool((dq[0] == 0).all()) and \
                        bool((out[0] == 0).all())
                ok = ok and exact
            dq_ms = cuda_ms(lambda: fa._launch_dq(q, k, v, dout, lse, delta,
                                                  args))
            dkv_ms = cuda_ms(lambda: fa._launch_dkv(q, k, v, dout, lse,
                                                    delta, args))
            plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, out, lse, dout, **kw), iters=5)
            lib_a, lib_b, lib_events = _sdpa_backward_ms(q, k, v, dout, kw)
            (dq_bound, dq_by), (dkv_bound, dkv_by) = _bwd_bounds(
                dname, kw, shape, q.element_size())
            row = {"dtype": dname, "case": case, "shape": shape,
                   "max_abs_err": errs, "err_over_tol": ratio,
                   "fwd_err_over_tol": fwd_ratio, "lse_max_abs_err": lse_err,
                   "tol": [atol, rtol], "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                   "plain_ms": plain_ms, "library_ms": (lib_a + lib_b) / 2,
                   "library_ms_windows": [lib_a, lib_b],
                   "library_ms_events": lib_events,
                   "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
                   "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
                   "ok": ok}
            rows.append(row)
            log(f"kernel_bwd {dname:8s} {case:18s} {tuple(shape)} "
                f"err dq={errs['dq']:.2e} dk={errs['dk']:.2e} "
                f"dv={errs['dv']:.2e} ({ratio:.2f} of tol; fwd out "
                f"{fwd_ratio:.2f} of tol, lse_err={lse_err:.2e}) "
                f"dq_ms={dq_ms:.4f} (bound {dq_bound:.4f} {dq_by}) "
                f"dkv_ms={dkv_ms:.4f} (bound {dkv_bound:.4f} {dkv_by}) "
                f"plain_ms={plain_ms:.4f} sdpa_bwd_ms={lib_a:.4f}/"
                f"{lib_b:.4f} (events {lib_events:.4f}) "
                f"{'ok' if ok else 'FAILED'}")
            del q, k, v, kw, dout, out, lse, dq, dk, dv, plain, delta, args
            del ref_out, ref_lse
    torch.cuda.empty_cache()
    failed = [_case_name(r) for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"backward kernels disagree with the plain "
                         f"backward: {failed}")
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
def _device_times(prof):
    """ms on the device by kernel name, and the kernel launches, of a
    finished ``torch.profiler`` trace (device work only, not the ops)."""
    import torch
    per_kernel, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        per_kernel[evt.key] = us / 1e3
        launches += evt.count
    return per_kernel, launches


def device_ms(fn, iters=20):
    """Time per call of ``fn()`` that the card spends running its
    kernels, summed by ``torch.profiler`` over ``iters`` calls after one
    warm-up: the host's launch gaps are left out, for calls whose host
    work outlasts their device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_device_times(prof)[0].values()) / iters


def profile_call(fn, label, back_to_back_ms):
    """Trace one call of ``fn`` with ``torch.profiler``: the device time
    summed over kernels, the share of ``back_to_back_ms`` the card was
    idle, the kernel launches and the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel, launches = _device_times(prof)
    total = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"what": label, "back_to_back_ms": back_to_back_ms,
           "device_ms_traced": total if total else "not measured",
           "idle_share": (1 - total / back_to_back_ms) if total
           else "not measured",
           "kernel_launches": launches, "top_kernels_ms": top}
    log(f"profile: {label}: {back_to_back_ms:.3f} ms back to back, "
        f"{total:.3f} ms of it on the device in {launches} kernel launches")
    for name, ms in top:
        log(f"profile:   {ms:9.3f} ms  {name[:90]}")
    return out


def profile_forward(net, dev, rows, seq_len):
    """One forward at (rows, seq_len): its time back to back by CUDA
    events (bounded by the host when the host launches slower than the
    card runs) and its trace."""
    import torch

    vocab = net.word_embed._input_dim
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, vocab, (rows, seq_len), generator=gen).to(dev)
    segments = torch.zeros_like(tokens)
    valid = torch.ones_like(tokens)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: net(tokens, segments, valid), iters=10)
        return profile_call(lambda: net(tokens, segments, valid),
                            f"forward at ({rows}, {seq_len})", fwd_ms)


def phase_profile(net, dev):
    for blk in net.modules():
        if hasattr(blk, "_use_flash"):
            blk._use_flash = True
    return [profile_forward(net, dev, 8, 512),
            profile_forward(net, dev, 1, 128)]


# ---------------------------------------------------------------------------
# phase 3b: training BERT-base pretraining
# ---------------------------------------------------------------------------
def pretrain_loss(model):
    """The repo's BERT pretraining loss (`benchmark/bert_pretrain_bench.py`
    `PretrainLoss`): masked MLM over valid positions plus NSP, in f32."""
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import HybridBlock

    class PretrainLoss(HybridBlock):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, tokens, segments, labels, valid_mask):
            mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
            logp = npx.log_softmax(mlm_logits.float(), axis=-1)
            picked = npx.pick(logp, labels, axis=-1)
            m = valid_mask.float()
            mlm = -(picked * m).sum() / m.sum()
            nsp = -npx.log_softmax(nsp_logits.float())[:, 0].mean()
            return mlm + nsp

    return PretrainLoss(model)


def train_batch(dev, vocab, seed=12):
    """Tokens and labels from a seeded numpy generator, segments zero,
    the ragged valid mask of `train_mask`."""
    import numpy as onp
    import torch
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B_TRAIN, T_TRAIN)).astype(onp.int32)
    labels = rng.integers(0, vocab, (B_TRAIN, T_TRAIN)).astype(onp.int32)
    segments = onp.zeros((B_TRAIN, T_TRAIN), onp.int32)
    return [torch.from_numpy(a).to(dev) for a in
            (tokens, segments, labels, train_mask(B_TRAIN, T_TRAIN))]


def _launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    return {k.name: k.launches
            for k in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)}


def _reset_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    for k in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV):
        k.launches = 0


def _snapshot(mod, trainer):
    opt = trainer.optimizer
    return ({k: p.data().detach().clone()
             for k, p in mod.collect_params().items()},
            {i: tuple(x.clone() for x in st)
             for i, st in trainer._states.items()},
            (dict(opt._index_update_count), opt.num_update))


def _restore(mod, trainer, snap):
    import torch
    weights, states, (counts, num_update) = snap
    with torch.no_grad():
        for k, p in mod.collect_params().items():
            p.data().copy_(weights[k])
        for i, st in trainer._states.items():
            for x, y in zip(st, states[i]):
                x.copy_(y)
    trainer.optimizer._index_update_count = dict(counts)
    trainer.optimizer.num_update = num_update


def _eager_vs_fused(mod, trainer, args):
    """One eager record/backward/Trainer.step step and one FusedTrainStep
    step from the same weights, optimizer state and dropout seeds.  The
    eager Trainer hands update_math an f32 gradient, the fused step one
    cast back to bf16 (the reference's rounding points), so Adam's step
    differs by that rounding only and a bf16 weight by at most one ulp
    (|diff| <= 2^-7 |w|)."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import FusedTrainStep

    snap = _snapshot(mod, trainer)
    with autograd.record(generator=torch.Generator().manual_seed(77)):
        loss_e = mod(*args)
    loss_e.backward()
    trainer.step(B_TRAIN)
    eager = {k: p.data().detach().clone()
             for k, p in mod.collect_params().items()}
    _restore(mod, trainer, snap)
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(77))
    loss_f = step(*args, batch_size=B_TRAIN)
    worst, n_diff, n_all = 0.0, 0, 0
    for k, p in mod.collect_params().items():
        w_f, w_e = p.data().detach().float(), eager[k].float()
        diff = (w_e - w_f).abs()
        worst = max(worst, (diff / (EAGER_FUSED_ULP * w_f.abs() + 1e-30)
                            ).max().item())
        n_diff += int((diff != 0).sum())
        n_all += diff.numel()
    out = {"loss_eager": loss_e.item(), "loss_fused": loss_f.item(),
           "worst_diff_over_one_ulp": worst, "elements_differing": n_diff,
           "elements": n_all}
    log("train: eager vs fused step: " + json.dumps(out))
    if worst > 1.0 or out["loss_eager"] != out["loss_fused"]:
        raise SystemExit("eager and fused training steps disagree")
    return out


def _flash_vs_dense_grads(dev, args):
    """Gradients of one backward with flash attention and with dense
    attention, BERT-base width, 2 layers, f32, dropout 0: relative L2 per
    parameter.  The attention key biases are left out: softmax ignores a
    per-row constant, so their gradient is rounding noise on both paths
    (its norm is printed)."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models import BertForPretraining

    net = BertForPretraining(**dict(TRAIN_CFG, num_layers=2, dropout=0.0)
                             ).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(2))
    mod = pretrain_loss(net)
    grads = []
    for flash in (True, False):
        for blk in net.modules():
            if hasattr(blk, "_use_flash"):
                blk._use_flash = flash
        with autograd.record():
            loss = mod(*args)
        loss.backward()
        grads.append({k: p.grad().clone()
                      for k, p in mod.collect_params().items()})
    worst, worst_name, noise = 0.0, None, 0.0
    for k, g_flash in grads[0].items():
        g_dense = grads[1][k]
        if k.endswith("attention.key.bias"):
            noise = max(noise, g_flash.norm().item(), g_dense.norm().item())
            continue
        err = rel_err(g_flash, g_dense)
        if err > worst:
            worst, worst_name = err, k
    out = {"worst_rel_l2": worst, "worst_param": worst_name,
           "tol": GRAD_REL_TOL, "key_bias_grad_norm": noise}
    log("train: flash vs dense gradients: " + json.dumps(out))
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("flash and dense gradients disagree")
    return out


def phase_train(dev):
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.models import BertForPretraining

    net = BertForPretraining(**TRAIN_CFG).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    mod = pretrain_loss(net)
    args = train_batch(dev, TRAIN_CFG["vocab_size"])
    trainer = Trainer(mod.collect_params(), "adam", {"learning_rate": 1e-4})
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(1))
    losses = [step(*args, batch_size=B_TRAIN) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()

    per_step = []
    _reset_counts()                          # count only the main path
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = _launch_counts()
        losses.append(step(*args, batch_size=B_TRAIN))
        after = _launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _launch_counts()
    n_layers = TRAIN_CFG["num_layers"]
    loss_vals = torch.stack(losses).float().cpu().tolist()
    measured = loss_vals[TRAIN_WARMUP:]
    falling = sum(measured[-5:]) / 5 < measured[0]
    finite = all(x == x and abs(x) != float("inf") for x in loss_vals)
    counts_ok = all(c == n_layers for s in per_step for c in s.values())
    step_ms = wall / TRAIN_STEPS * 1e3
    out = {"model": "BertForPretraining (bert_base width)", "dtype":
           "bfloat16", "batch": [B_TRAIN, T_TRAIN], "steps": TRAIN_STEPS,
           "warmup_steps": TRAIN_WARMUP, "step_ms": step_ms,
           "tokens_per_s": B_TRAIN * T_TRAIN * TRAIN_STEPS / wall,
           "valid_occupancy": float(args[3].float().mean().item()),
           "loss_first": measured[0], "loss_last5_mean":
           sum(measured[-5:]) / 5, "losses": measured,
           "launches": totals, "launches_per_step_ok": counts_ok,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": nvidia_smi()}
    log("train: " + json.dumps(out))
    if not (finite and falling and counts_ok):
        raise SystemExit(f"training failed: finite={finite} "
                         f"falling={falling} launches per step ok="
                         f"{counts_ok}")
    out["eager_vs_fused"] = _eager_vs_fused(mod, trainer, args)
    out["profile"] = phase_train_profile(step, args)
    del step, trainer, mod, net
    torch.cuda.empty_cache()
    out["flash_vs_dense"] = _flash_vs_dense_grads(dev, args)
    return out


# ---------------------------------------------------------------------------
# phase 4b: where one training step's time goes
# ---------------------------------------------------------------------------
def _count_syncs(fn):
    """Device-to-host synchronisations torch reports during ``fn()``
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # each synchronizing call warns "called a synchronizing CUDA
    # operation"; the mode's own notice that it is a prototype does not
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs), syncs[:3]


def phase_train_profile(step, args):
    import torch

    def one():
        return step(*args, batch_size=B_TRAIN)

    # the count is only as good as the debug mode's coverage: check that
    # it sees a known sync (a scalar read) before trusting a zero
    seen, _ = _count_syncs(lambda: torch.ones(1, device="cuda").item())
    n_syncs, examples = _count_syncs(one)
    if seen < 1:
        n_syncs = "not measured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    out = profile_call(one, f"training step at ({B_TRAIN}, {T_TRAIN})",
                       step_ms)
    out["host_syncs_per_step"] = n_syncs
    log(f"profile: training step: {n_syncs} device-to-host syncs "
        f"{examples}")
    return out


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
    bwd_rows = phase_bwd_vs_plain(dev)
    served, net = phase_serve(dev)
    phase_profile(net, dev)
    del net
    torch.cuda.empty_cache()
    trained = phase_train(dev)
    log(f"seconds: {time.perf_counter() - t_start:.1f}")

    main_case = next(r for r in rows
                     if r["dtype"] == "bfloat16" and r["case"] == "ragged_mask"
                     and r["shape"] == [B, H, T, D])
    bwd_case = next(r for r in bwd_rows
                    if r["dtype"] == "bfloat16" and
                    r["case"] == "train_mask_dropout")
    bwd_src = "mxnet_tpu_torch/csrc/flash_attention_bwd.cu"
    launches = trained["launches"]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:366",
        "launches": served["flash_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": bwd_src,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:536",
        "launches": launches["flash_attention_bwd_dq"],
        "max_abs_err": bwd_case["max_abs_err"]["dq"],
        "ms": bwd_case["dq_ms"], "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case["dq_bound_ms"],
        "bound_by": bwd_case["dq_bound_by"],
        "library_ms": bwd_case["library_ms"],
    }, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": bwd_src,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:604",
        "launches": launches["flash_attention_bwd_dkv"],
        "max_abs_err": max(bwd_case["max_abs_err"]["dk"],
                           bwd_case["max_abs_err"]["dv"]),
        "ms": bwd_case["dkv_ms"], "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case["dkv_bound_ms"],
        "bound_by": bwd_case["dkv_bound_by"],
        "library_ms": bwd_case["library_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
