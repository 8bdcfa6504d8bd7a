"""Package rules of the PyTorch/CUDA port.

The port (``mxnet_tpu_torch/`` and ``chip_smoke.py``) imports neither JAX,
nor anything of the JAX package, nor ``ml_dtypes`` (the port's
checkpoints decode bfloat16 through torch), and its entry points run on
the card unless the caller names the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")

torch.set_num_threads(1)


def _imports(path):
    """Top-level module names that ``path`` imports (absolute imports
    only; relative imports stay inside the port)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.ops.flash_attention, "
            "mxnet_tpu_torch.utils.convert, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.fused_step, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.ops.stem, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.optimizer.sgd, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.operator, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.utils.serialization, "
            "mxnet_tpu_torch.utils.legacy_format, mxnet_tpu_torch.amp, "
            "mxnet_tpu_torch.amp.loss_scaler, mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch.numpy, mxnet_tpu_torch.optimizer.adam, "
            "mxnet_tpu_torch.optimizer.rmsprop, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.recordio, mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch._native, mxnet_tpu_torch.env, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.ops.threefry, "
            "mxnet_tpu_torch.random, mxnet_tpu_torch.lockwitness, "
            "mxnet_tpu_torch.observe, mxnet_tpu_torch.observe.flightrec, "
            "mxnet_tpu_torch.profiler, mxnet_tpu_torch.telemetry, "
            "mxnet_tpu_torch.telemetry.registry, "
            "mxnet_tpu_torch.telemetry.spans, "
            "mxnet_tpu_torch.telemetry.watchdog, mxnet_tpu_torch.monitor, "
            "mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.resilience.faultline, "
            "mxnet_tpu_torch.resilience.policies, "
            "mxnet_tpu_torch.resilience.checkpoint, "
            "mxnet_tpu_torch.resilience.sentinel, "
            "mxnet_tpu_torch._distributed, mxnet_tpu_torch.parallel, "
            "mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.kvstore.tpu_ici, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu', 'ml_dtypes')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_sets_true_f32():
    import mxnet_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_need_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import BertModel

    assert mx.current_context() == torch.device("cuda", 0)
    cfg = dict(vocab_size=10, units=8, hidden_size=16, num_layers=1,
               num_heads=2, max_length=8)
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        BertModel(**cfg).initialize()
    net = BertModel(**cfg).initialize(ctx=mx.cpu())
    assert net.collect_params()["pooler.weight"].data().device.type == "cpu"


def test_resnet_needs_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        vision.resnet50_v1().initialize()
    net = vision.resnet50_v1()
    net.initialize(ctx=mx.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 3, 32, 32))
    assert net.collect_params()["output.weight"].data().device.type == "cpu"
