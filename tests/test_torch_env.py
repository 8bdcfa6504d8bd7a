"""The port's `env` against the JAX package's.

- ``describe()`` lists the reference's variables, in its order, each
  documented in the port's table;
- every reader of the reference's ``__all__`` returns what the
  reference's returns, for unset, ordinary and out-of-range values;
- ``apply()``: ``MXNET_SEED`` seeds the port's ``random`` (the
  reference's root key words), ``MXNET_ENFORCE_DETERMINISM`` turns on
  ``torch.use_deterministic_algorithms``, ``MXNET_PROFILER_AUTOSTART``
  starts the port's profiler; ``MXNET_ENGINE_TYPE`` is read.

Every variable is set with ``monkeypatch`` and every global the test
changes (the random stream, torch's determinism, the profiler) is put
back.
"""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu.env as ref
import mxnet_tpu_torch.env as port
import mxnet_tpu_torch.random as prandom
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.ops import invoke

torch.set_num_threads(1)

# (reader, variable, values): None is unset
READERS = [
    ("cpu_worker_nthreads", "MXNET_CPU_WORKER_NTHREADS", [None, "3", "0"]),
    ("decode_threads", "MXNET_DECODE_THREADS", [None, "5", "-2"]),
    ("prefetch_depth", "MXNET_PREFETCH_DEPTH", [None, "4", "0"]),
    ("io_error_tolerance", "MXNET_IO_ERROR_TOLERANCE", [None, "0.5", "-1"]),
    ("serve_replicas", "MXNET_SERVE_REPLICAS", [None, "3", "0"]),
    ("serve_deadline_ms", "MXNET_SERVE_DEADLINE_MS", [None, "250", "0.1"]),
    ("serve_eject_after", "MXNET_SERVE_EJECT_AFTER", [None, "4", "0"]),
    ("elastic_enabled", "MXNET_ELASTIC", [None, "1", "0", ""]),
    ("elastic_min_world", "MXNET_ELASTIC_MIN_WORLD", [None, "2", "0"]),
    ("elastic_scaling", "MXNET_ELASTIC_SCALING", [None, "none", "linear"]),
    ("sentinel_slow_factor", "MXNET_SENTINEL_SLOW_FACTOR",
     [None, "2.5", "0.5"]),
    ("sentinel_loss_factor", "MXNET_SENTINEL_LOSS_FACTOR", [None, "4", "0"]),
    ("sentinel_rollbacks", "MXNET_SENTINEL_ROLLBACKS", [None, "5", "-1"]),
    ("kvstore_integrity", "MXNET_KVSTORE_INTEGRITY", [None, "1", "0"]),
    ("parallel_recipe", "MXNET_PARALLEL_RECIPE", [None, " dp2.tp2 ", " "]),
    ("recipe_strict", "MXNET_RECIPE_STRICT", [None, "1", "0", ""]),
    ("blackbox_enabled", "MXNET_BLACKBOX", [None, "0", "1"]),
    ("blackbox_events", "MXNET_BLACKBOX_EVENTS", [None, "100", "3"]),
    ("blackbox_dir", "MXNET_BLACKBOX_DIR", [None, " /x ", " "]),
    ("autotune_enabled", "MXNET_AUTOTUNE", [None, "0", "1"]),
    ("autotune_cache_path", "MXNET_AUTOTUNE_CACHE", [None, "a.json", ""]),
    ("lockscan_witness", "MXNET_LOCKSCAN_WITNESS", [None, "1", "0"]),
    ("lockscan_report_path", "MXNET_LOCKSCAN_REPORT", [None, "r.json", " "]),
]


def test_the_port_reads_the_reference_s_variables():
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert [n for n, _v, _doc in port.describe()] == \
        [n for n, _v, _doc in ref.describe()]
    assert all(doc for _n, _v, doc in port.describe())
    assert {r for r, _v, _vals in READERS} | {"apply", "describe",
                                              "is_naive_engine"} == \
        set(ref.__all__)


@pytest.mark.parametrize("reader,var,values", READERS,
                         ids=[r for r, _v, _x in READERS])
def test_reader_matches_the_reference(monkeypatch, reader, var, values):
    for value in values:
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        assert getattr(port, reader)() == getattr(ref, reader)(), value


def test_decode_threads_falls_back_as_the_reference(monkeypatch):
    monkeypatch.delenv("MXNET_DECODE_THREADS", raising=False)
    monkeypatch.delenv("MXNET_CPU_WORKER_NTHREADS", raising=False)
    assert port.decode_threads(6) == ref.decode_threads(6) == 6
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "2")
    assert port.decode_threads(6) == ref.decode_threads(6) == 2


def test_elastic_scaling_refuses_what_the_reference_refuses(monkeypatch):
    monkeypatch.setenv("MXNET_ELASTIC_SCALING", "cubic")
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.elastic_scaling()


@pytest.fixture
def restored():
    st = prandom._state
    saved = (st.root, st.counter, st.host, st.host_seeded_with,
             list(prandom._host_seed), list(prandom._host_spawn))
    gen = invoke.set_default_generator(None)
    det = torch.are_deterministic_algorithms_enabled()
    yield
    (st.root, st.counter, st.host, st.host_seeded_with,
     prandom._host_seed[:], prandom._host_spawn[:]) = saved
    invoke.set_default_generator(gen)
    torch.use_deterministic_algorithms(det)
    if profiler.state() == "run":
        profiler.set_state("stop")
    profiler.dumps(reset=True)


def test_apply_reads_the_import_time_knobs(monkeypatch, restored):
    for var in ("MXNET_SEED", "MXNET_ENFORCE_DETERMINISM",
                "MXNET_PROFILER_AUTOSTART", "MXNET_ENGINE_TYPE",
                "MXNET_EXEC_BULK_EXEC_TRAIN"):
        monkeypatch.delenv(var, raising=False)
    port.apply()
    assert not port.is_naive_engine()
    monkeypatch.setenv("MXNET_SEED", "11")
    monkeypatch.setenv("MXNET_ENFORCE_DETERMINISM", "1")
    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "1")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    monkeypatch.setenv("MXNET_EXEC_BULK_EXEC_TRAIN", "x")
    port.apply()
    key = onp.asarray(jax.random.key_data(jax.random.key(11)))
    assert prandom._state.root.tolist() == key.tolist()
    assert prandom.default_generator().initial_seed() == 11
    assert torch.are_deterministic_algorithms_enabled()
    assert profiler.state() == "run"
    assert port.is_naive_engine()
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "ThreadedEngine")
    port.apply()
    assert not port.is_naive_engine()
