"""The port's continuous batcher (`mxnet_tpu_torch.serve.ContinuousBatcher`)
against the JAX package's, on the CPU.

- ``_int_lm``, the reference test's integer "language model"
  (``tests/test_fleet.py``), written in torch, and the reference's in
  ``jax.numpy``: the same prompts and budgets through both batchers give
  the same token arrays, equal to the solo oracle, under join/leave
  traffic and eos; a carry of the wrong shape fails its own future only;
  validation and close.
- A 2-layer LSTM word LM (`models.RNNModel`, vocab 50, 16 units, tied
  weights) with the reference's weights (U(-1, 1), seed 5; prompts
  from seed 0), greedy-decoded by both
  packages' batchers on the same prompts: the same tokens; along each
  generated path, both models' logits at every step within atol = rtol
  = 1e-5 (f32, 16-term sums over two layers), and every step's top-2
  margin above that tolerance (a smaller margin would let the two
  argmaxes part by rounding alone, and fails with a message of its own).
- The decode's capture bookkeeping on the CPU, with a stand-in for the
  CUDA graph (as in ``test_torch_capture.py``): its capture runs nothing,
  as a CUDA capture runs nothing; its replay runs the captured step.
  One capture over the batcher's life; a decode failure zeroes the
  static buffers in place and costs no second capture and no retrace;
  joins never rebind the static stack.
"""
import time

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.models import RNNModel as RefRNNModel
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.serve import ContinuousBatcher as RefBatcher
from mxnet_tpu_torch import autograd, cpu, telemetry
from mxnet_tpu_torch.models import RNNModel
from mxnet_tpu_torch.ops import capture
from mxnet_tpu_torch.serve import ContinuousBatcher, EndpointClosed
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

LOGIT_TOL = 1e-5


def _int_lm_ref():
    """The reference test's model, in jax.numpy."""
    def prefill(prompt):
        h = (jnp.sum(prompt).astype(jnp.int32) * 13
             + jnp.int32(prompt.shape[0])) % 1000
        return h, (h % 7).astype(jnp.int32)

    def decode(h_stack, toks):
        new = (h_stack * 3 + toks.astype(jnp.int32)) % 1000
        return new, (new % 7).astype(jnp.int32)

    return prefill, decode


def _int_lm():
    """The same model in torch, and the solo oracle."""
    def prefill(prompt):
        p = torch.from_numpy(onp.asarray(prompt, onp.int32))
        h = (p.sum().to(torch.int32) * 13 + p.shape[0]) % 1000
        return h, (h % 7).to(torch.int32)

    def decode(h_stack, toks):
        new = (h_stack * 3 + toks.to(torch.int32)) % 1000
        return new, (new % 7).to(torch.int32)

    def oracle(prompt, budget, eos_id=None):
        h = (int(onp.sum(prompt)) * 13 + len(prompt)) % 1000
        toks = [h % 7]
        while len(toks) < budget:
            h = (h * 3 + toks[-1]) % 1000
            toks.append(h % 7)
        if eos_id is not None and eos_id in toks:
            toks = toks[:toks.index(eos_id)]
        return onp.asarray(toks, dtype=onp.int64)

    return prefill, decode, oracle


def _run(batcher, prompts, budgets, gap_s=0.01):
    futs = []
    for p, b in zip(prompts, budgets):
        futs.append(batcher.submit(p, max_new_tokens=b))
        time.sleep(gap_s)                # joins land mid-decode
    return [f.result(timeout=60) for f in futs]


def test_join_leave_matches_jax_batcher_and_oracle(rng):
    prefill, decode, oracle = _int_lm()
    prompts = [rng.integers(0, 50, size=rng.integers(1, 6))
               .astype(onp.int32) for _ in range(7)]
    budgets = [1, 3, 6, 4, 2, 5, 6]
    with RefBatcher(*_int_lm_ref(), slots=3, name="t_cont") as ref_cb:
        theirs = _run(ref_cb, prompts, budgets)
    with ContinuousBatcher(prefill, decode, slots=3, name="t_cont") as cb:
        mine = _run(cb, prompts, budgets)
    for out, ref_out, p, b in zip(mine, theirs, prompts, budgets):
        assert out.dtype == ref_out.dtype == onp.int64
        onp.testing.assert_array_equal(out, ref_out)
        onp.testing.assert_array_equal(out, oracle(p, b))
    s, ref_s = cb.stats(), ref_cb.stats()
    assert s["joins"] == ref_s["joins"] == 7
    assert s["leaves"] == ref_s["leaves"] == 7
    assert s["active"] == 0 and s["waiting"] == 0


def test_eos_terminates_and_is_excluded_as_jax():
    prefill, decode, oracle = _int_lm()
    eos = 3
    prompt = None
    for v in range(200):
        toks = oracle(onp.asarray([v], onp.int32), 12)
        if eos in toks.tolist()[1:-1]:
            prompt = onp.asarray([v], onp.int32)
            break
    assert prompt is not None
    with RefBatcher(*_int_lm_ref(), slots=2, eos_id=eos,
                    name="t_eos") as ref_cb:
        theirs = ref_cb.generate(prompt, max_new_tokens=12, timeout=60)
    with ContinuousBatcher(prefill, decode, slots=2, eos_id=eos,
                           name="t_eos") as cb:
        mine = cb.generate(prompt, max_new_tokens=12, timeout=60)
    expect = oracle(prompt, 12, eos_id=eos)
    assert len(expect) < 12              # eos actually fired early
    onp.testing.assert_array_equal(mine, theirs)
    onp.testing.assert_array_equal(mine, expect)
    assert eos not in mine.tolist()      # terminator, not output


def test_bad_carry_fails_only_that_future():
    """A carry whose shape tracks the prompt length fails ITS future,
    with the reference's message; the worker keeps serving."""
    def prefill(prompt):
        p = torch.from_numpy(onp.asarray(prompt, onp.int32))
        return p, p[0] % 7

    def decode(stack, toks):
        return stack, (stack.sum(dim=1).to(torch.int32) + toks) % 7

    def ref_prefill(prompt):
        return prompt.astype(jnp.int32), (prompt[0] % 7).astype(jnp.int32)

    def ref_decode(stack, toks):
        return stack, (jnp.sum(stack, axis=1).astype(jnp.int32) + toks) % 7

    outs = {}
    for key, make, fns in (("ref", RefBatcher, (ref_prefill, ref_decode)),
                           ("port", ContinuousBatcher, (prefill, decode))):
        with make(*fns, slots=2, name="t_badcarry") as cb:
            first = cb.generate(onp.asarray([9, 2, 4], onp.int32),
                                max_new_tokens=1, timeout=60)
            bad = cb.submit(onp.asarray([1, 2], onp.int32),
                            max_new_tokens=1)
            with pytest.raises(ValueError, match="per-slot shape") as exc:
                bad.result(timeout=60)
            after = cb.generate(onp.asarray([8, 1, 1], onp.int32),
                                max_new_tokens=1, timeout=60)
        outs[key] = (first.tolist(), after.tolist(), str(exc.value))
        s = cb.stats()
        assert s["active"] == 0 and s["waiting"] == 0
    assert outs["port"][:2] == outs["ref"][:2] == ([2], [1])
    assert "(2,)" in outs["port"][2] and "(3,)" in outs["port"][2]


def test_validation_and_close():
    prefill, decode, _ = _int_lm()
    cb = ContinuousBatcher(prefill, decode, slots=2, name="t_cval",
                           start=False)
    with pytest.raises(ValueError, match="non-empty 1-D"):
        cb.submit(onp.zeros((2, 3), onp.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        cb.submit(onp.asarray([1], onp.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="decode slot"):
        ContinuousBatcher(prefill, decode, slots=0, start=False)
    cb.start()
    cb.shutdown(drain=True)
    with pytest.raises(EndpointClosed):
        cb.submit(onp.asarray([1], onp.int32))


def test_nondrain_close_fails_waiting():
    prefill, decode, _ = _int_lm()
    cb = ContinuousBatcher(prefill, decode, slots=1, name="t_cnodrain",
                           start=False)
    futs = [cb.submit(onp.asarray([i + 1], onp.int32), max_new_tokens=4)
            for i in range(3)]
    cb.start()
    cb.shutdown(drain=False, timeout=60)
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert isinstance(f.exception(), EndpointClosed)


# -- the word LM --------------------------------------------------------------

VOCAB, UNITS, LAYERS = 50, 16, 2


def _lm_pair(seed=5):
    """The reference's LM and the port's with its weights, drawn from
    U(-1, 1): the default initializer's scale leaves logits of order
    1e-3 whose top two lie within the tolerance of each other."""
    mx.random.seed(seed)
    ref = RefRNNModel(VOCAB, UNITS, UNITS, LAYERS, "lstm", dropout=0.0,
                      tie_weights=True)
    ref.initialize(mx.init.Uniform(1.0))
    net = RNNModel(VOCAB, UNITS, UNITS, LAYERS, "lstm", dropout=0.0,
                   tie_weights=True)
    net.initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    return ref, net


def _lm_fns(net):
    """prefill/decode over the port's RNNModel: the carry is (h, c) of
    (layers, units) a sequence, stacked on the slot axis."""
    def prefill(prompt):
        x = torch.from_numpy(onp.asarray(prompt, onp.int64)).reshape(-1, 1)
        with autograd.predict_mode(), torch.no_grad():
            logits, (h, c) = net(x, net.begin_state(1, ctx=cpu()))
        return (h[:, 0], c[:, 0]), logits[-1, 0].argmax()

    def decode(carry, toks):
        h, c = (s.transpose(0, 1) for s in carry)
        with autograd.predict_mode():
            logits, (h, c) = net(toks.reshape(1, -1).to(torch.int64),
                                 [h, c])
        return (h.transpose(0, 1), c.transpose(0, 1)), logits[0].argmax(-1)

    return prefill, decode


def _lm_fns_ref(ref):
    def prefill(prompt):
        logits, st = ref(NDArray(prompt.reshape(-1, 1)), ref.begin_state(1))
        h, c = (s._data[:, 0] for s in st)
        return (h, c), jnp.argmax(logits._data[-1, 0]).astype(jnp.int32)

    def decode(carry, toks):
        st = [NDArray(jnp.swapaxes(s, 0, 1)) for s in carry]
        logits, st = ref(NDArray(toks.reshape(1, -1)), st)
        return ((jnp.swapaxes(st[0]._data, 0, 1),
                 jnp.swapaxes(st[1]._data, 0, 1)),
                jnp.argmax(logits._data[0], -1).astype(jnp.int32))

    return prefill, decode


def _ref_steps(ref):
    """The reference LM over (T, 1) tokens from (h, c), jitted: the last
    position's logits and the new state."""
    import jax

    def run(x, h, c):
        logits, (h, c) = ref(NDArray(x), [NDArray(h), NDArray(c)])
        return logits._data[-1, 0], h._data, c._data

    return jax.jit(run)


def _path_logits(ref, ref_run, net, prompt, tokens):
    """Both models' logits at each generated step along ``tokens``: the
    prompt, then each token fed back (teacher forcing)."""
    h, c = (s._data for s in ref.begin_state(1))
    st = net.begin_state(1, ctx=cpu())
    mine, theirs = [], []
    for k in range(len(tokens)):
        x = (prompt if k == 0 else tokens[k - 1:k]).reshape(-1, 1)
        logits, h, c = ref_run(x.astype(onp.int32), h, c)
        theirs.append(onp.asarray(logits))
        with autograd.predict_mode(), torch.no_grad():
            out, st = net(torch.from_numpy(x.astype(onp.int64)), st)
        mine.append(out[-1, 0].numpy())
    return mine, theirs


def test_word_lm_greedy_decode_matches_jax():
    ref, net = _lm_pair()
    # two prompt lengths, so the reference compiles few prefills
    rng = onp.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).astype(onp.int32)
               for n in (3, 6, 3, 6, 3)]
    budgets = [6, 3, 5, 2, 8]
    with RefBatcher(*_lm_fns_ref(ref), slots=3, name="t_lm") as ref_cb:
        theirs = _run(ref_cb, prompts, budgets)
    with ContinuousBatcher(*_lm_fns(net), slots=3, name="t_lm") as cb:
        mine = _run(cb, prompts, budgets)
    ref_run = _ref_steps(ref)
    for out, ref_out, p, b in zip(mine, theirs, prompts, budgets):
        assert len(out) == b
        onp.testing.assert_array_equal(out, ref_out)
        logits, ref_logits = _path_logits(ref, ref_run, net, p, out)
        for k, (lg, rl) in enumerate(zip(logits, ref_logits)):
            top2 = onp.sort(rl)[-2:]
            if top2[1] - top2[0] <= LOGIT_TOL:
                pytest.fail(
                    f"step {k}: the reference's top-2 logit margin "
                    f"{top2[1] - top2[0]:.3g} is within the tolerance "
                    f"{LOGIT_TOL}; the argmax is decided by rounding")
            onp.testing.assert_allclose(lg, rl, atol=LOGIT_TOL,
                                        rtol=LOGIT_TOL)
            assert int(onp.argmax(lg)) == int(out[k])


# -- capture bookkeeping, with a stand-in for the CUDA graph -----------------

class _StandIn(capture.Graph):
    """A graph whose capture runs nothing and whose replay runs the
    captured function."""

    made = []

    def _record(self, fn):
        _StandIn.made.append(self)
        self._fn = fn

    def _launch(self):
        self._fn()


@pytest.fixture
def standin(monkeypatch):
    _StandIn.made = []
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    return _StandIn


def test_decode_captures_once_and_resets_without_retrace(standin, rng):
    prefill, decode, oracle = _int_lm()
    fail = {"on": False}

    def failing_decode(h_stack, toks):
        if fail["on"]:
            fail["on"] = False
            raise RuntimeError("decode failed")
        return decode(h_stack, toks)

    name = "t_capture"
    wd = telemetry.watchdog()
    before = wd.retrace_count(f"serve/{name}/decode")
    prompts = [rng.integers(0, 50, size=3).astype(onp.int32)
               for _ in range(5)]
    with ContinuousBatcher(prefill, failing_decode, slots=2,
                           name=name) as cb:
        first = _run(cb, prompts[:2], [5, 4])
        stack, last = cb._carry, cb._last
        ptrs = (stack.data_ptr(), last.data_ptr())
        fail["on"] = True
        with pytest.raises(RuntimeError, match="decode failed"):
            cb.generate(prompts[2], max_new_tokens=6, timeout=60)
        assert cb._carry is stack and cb._last is last
        after = _run(cb, prompts[3:], [6, 3])
        assert (cb._carry.data_ptr(), cb._last.data_ptr()) == ptrs
        steps = cb.stats()["steps"]
    for out, p, b in zip(first + after, prompts[:2] + prompts[3:],
                         [5, 4, 6, 3]):
        onp.testing.assert_array_equal(out, oracle(p, b))
    assert len(standin.made) == 1
    assert cb._decode.captures == 1
    assert standin.made[0].replays == steps
    assert wd.retrace_count(f"serve/{name}/decode") == before
