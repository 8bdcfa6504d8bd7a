"""The port's `gluon.metric` against the JAX package's.

Each metric gets the same seeded updates in both packages (the
reference numpy arrays, the port torch tensors, one of them bf16), then
``get()`` must agree; also `create` by name, list and callable, the
registry, `CompositeEvalMetric`, ``get_name_value``, ``reset`` and
``update_dict``.

Tolerance: the same numpy arithmetic on the host in both packages, on
inputs that are equal (the port widens bf16 to f32 on the host, and the
reference gets the same widened values): rtol 1e-6.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu.gluon import metric as ref_metric
from mxnet_tpu_torch.gluon import metric

torch.set_num_threads(1)

RNG = onp.random.default_rng(0)
N, K = 12, 4
PROBS = RNG.dirichlet(onp.ones(K), (3, N)).astype(onp.float32)
CLASSES = RNG.integers(0, K, (3, N)).astype(onp.float32)
BINARY = RNG.integers(0, 2, (3, N)).astype(onp.float32)
SCORES = RNG.uniform(size=(3, N)).astype(onp.float32)
REG_PRED = RNG.standard_normal((3, N, 3)).astype(onp.float32)
REG_LABEL = RNG.standard_normal((3, N, 3)).astype(onp.float32)


def _updates(name):
    """Three (labels, preds) updates for metric ``name``, as numpy."""
    if name in ("Accuracy", "TopKAccuracy", "CrossEntropy",
                "NegativeLogLikelihood", "Perplexity", "PCC"):
        return [(CLASSES[i], PROBS[i]) for i in range(3)]
    if name in ("F1", "MCC", "Fbeta", "BinaryAccuracy"):
        return [(BINARY[i], SCORES[i]) for i in range(3)]
    if name == "Loss":
        return [(None, SCORES[i]) for i in range(3)]
    return [(REG_LABEL[i], REG_PRED[i]) for i in range(3)]


METRICS = [
    ("Accuracy", {}), ("TopKAccuracy", {"top_k": 2}), ("F1", {}),
    ("F1", {"threshold": 0.3}), ("MCC", {}), ("MAE", {}), ("MSE", {}),
    ("RMSE", {}), ("CrossEntropy", {}), ("NegativeLogLikelihood", {}),
    ("PearsonCorrelation", {}), ("Perplexity", {}),
    ("Perplexity", {"ignore_label": 1}), ("Loss", {}), ("Fbeta",
                                                      {"beta": 2.0}),
    ("BinaryAccuracy", {"threshold": 0.6}), ("MeanPairwiseDistance", {}),
    ("MeanPairwiseDistance", {"p": 1}), ("MeanCosineSimilarity", {}),
    ("PCC", {}),
]


def _as_torch(a, i):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if i == 1 and a.dtype == onp.float32 \
        and t.is_floating_point() and a.ndim == 1 and a.max() <= 1 else t


@pytest.mark.parametrize("name,kw", METRICS)
def test_metric_matches_reference(name, kw):
    ref = getattr(ref_metric, name)(**kw)
    mine = getattr(metric, name)(**kw)
    for i, (label, pred) in enumerate(_updates(name)):
        pred_t = _as_torch(pred, i)
        # the reference gets exactly what the port reads on the host
        pred_np = pred_t.float().numpy() if pred_t.dtype == torch.bfloat16 \
            else pred
        ref.update(None if label is None else [label], [pred_np])
        mine.update(None if label is None else [torch.from_numpy(label)],
                    [pred_t])
    r_name, r_val = ref.get()
    m_name, m_val = mine.get()
    assert m_name == r_name
    onp.testing.assert_allclose(m_val, r_val, rtol=1e-6)
    assert mine.get_name_value() == [(m_name, m_val)]
    mine.reset()
    assert onp.isnan(mine.get()[1])


def test_custom_metric_and_np_wrapper():
    def feval(label, pred):
        return float(onp.abs(label - pred).sum())
    ref = ref_metric.np(feval, name="l1")
    mine = metric.np(feval, name="l1")
    for label, pred in _updates("MAE"):
        ref.update([label], [pred])
        mine.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
    assert mine.get()[0] == ref.get()[0] == "custom(l1)"
    onp.testing.assert_allclose(mine.get()[1], ref.get()[1], rtol=1e-6)
    pair = metric.CustomMetric(lambda lab, p: (len(lab), 2.0 * len(lab)))
    pair.update([torch.zeros(5)], [torch.zeros(5)])
    assert pair.get()[1] == 2.0


def test_create_registry_and_composite():
    for name in ("accuracy", "f1", "mse", "rmse", "perplexity", "pcc",
                 "topkaccuracy", "mae", "loss", "compositeevalmetric"):
        kw = {"top_k": 3} if name == "topkaccuracy" else {}
        assert type(metric.create(name, **kw)).__name__ == \
            type(ref_metric.create(name, **kw)).__name__
    acc = metric.Accuracy()
    assert metric.create(acc) is acc
    comp = metric.create(["accuracy", "crossentropy"])
    ref_comp = ref_metric.create(["accuracy", "crossentropy"])
    for label, pred in _updates("Accuracy"):
        comp.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        ref_comp.update([label], [pred])
    names, values = comp.get()
    r_names, r_values = ref_comp.get()
    assert names == r_names
    onp.testing.assert_allclose(values, r_values, rtol=1e-6)
    assert comp.get_metric(0).name == "accuracy"
    assert type(metric.create(lambda a, b: 0.0)).__name__ == "CustomMetric"

    @metric.register
    class Twice(metric.EvalMetric):
        def __init__(self):
            super().__init__("twice")

        def update(self, labels, preds):
            self.sum_metric += 2.0
            self.num_inst += 1
    t = metric.create("twice")
    t.update(None, None)
    assert t.get() == ("twice", 2.0)
    with pytest.raises(TypeError):
        metric.register(int)
    with pytest.raises(ValueError, match="Cannot find"):
        metric.create("no-such-metric")


def test_update_dict_and_config():
    m = metric.Accuracy(output_names=["out"], label_names=["lab"])
    m.update_dict({"lab": torch.tensor([1, 0])},
                  {"out": torch.tensor([[0.1, 0.9], [0.2, 0.8]])})
    assert m.get() == ("accuracy", 0.5)
    cfg = m.get_config()
    assert cfg["metric"] == "Accuracy" and cfg["axis"] == 1
    with pytest.raises(ValueError, match="top_k=1"):
        metric.TopKAccuracy(top_k=1)
