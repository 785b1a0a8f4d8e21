"""auformer_torch losses and metrics against the JAX package.

Every loss, ``LossSuite`` method and suite runs on the same numpy logits
and labels (sentinel rows included) in both packages, f32 on the CPU, at
rtol 1e-5 / atol 1e-6; the gradients of the avformer losses too. The
port's numpy metrics are held to the sklearn-backed ``auformer.metrics``
EXACTLY (==), absent classes and sklearn's zero-division cases included.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import accuracy_score as sk_accuracy
from sklearn.metrics import f1_score as sk_f1

from auformer import losses as jl
from auformer.losses import losses as jl_module
from auformer import metrics as jm
from auformer_torch import losses as tl
from auformer_torch import metrics as tm

RTOL, ATOL = 1e-5, 1e-6
B = 16


def _labels(seed, ignore_all=False):
    """(logits (B, 21), AU (B, 12) with -1 rows and cells, EX (B,) with
    class 7, VA (B, 2) with -5 sentinels)."""
    rs = np.random.RandomState(seed)
    logits = (rs.randn(B, 21) * 2).astype(np.float32)
    au = rs.randint(0, 2, (B, 12)).astype(np.float32)
    au[rs.rand(B, 12) < 0.1] = -1.0          # cells beyond col 0 are kept
    au[rs.rand(B) < 0.25, 0] = -1.0          # whole rows ignored
    ex = rs.randint(0, 8, B).astype(np.int32)
    va = rs.uniform(-1, 1, (B, 2)).astype(np.float32)
    va[rs.rand(B, 2) < 0.2] = -5.0
    if ignore_all:
        au[:, 0] = -1.0
        ex[:] = 7
        va[:] = -5.0
    return logits, au, ex, va


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


AU_LOSSES = ["au_bce_loss", "dice_au_loss", "smooth_au_loss",
             "focal_au_loss"]


@pytest.mark.parametrize("ignore_all", [False, True])
@pytest.mark.parametrize("name", AU_LOSSES)
def test_au_losses(name, ignore_all):
    logits, au, _, _ = _labels(1, ignore_all)
    got = getattr(tl, name)(torch.from_numpy(logits[:, :12]),
                            torch.from_numpy(au))
    want = getattr(jl, name)(jnp.asarray(logits[:, :12]), jnp.asarray(au))
    _close(got, want)
    if ignore_all and name == "au_bce_loss":
        assert float(got) == 0.0


@pytest.mark.parametrize("valid", [B, 1, 0])
@pytest.mark.parametrize("name", ["ccc_loss", "ccc_smooth_l1_loss"])
def test_va_losses(name, valid):
    """Full, one valid label (CCC 0) and none."""
    logits, _, _, va = _labels(2)
    va = va[:, 0].copy()
    va[:] = np.where(np.arange(B) < valid, np.abs(va) % 1, -5.0)
    pred = np.tanh(logits[:, 19])
    got = getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(va))
    want = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(va))
    _close(got, want)


EX_LOSSES = [("ex_ce_loss", {}), ("ex_ce_loss", {"weighted": True}),
             ("ex_focal_loss", {}), ("label_smoothing_ce_loss", {}),
             ("sce_and_focal_loss", {})]


@pytest.mark.parametrize("ignore_all", [False, True])
@pytest.mark.parametrize("name,kw", EX_LOSSES)
def test_ex_losses(name, kw, ignore_all):
    logits, _, ex, _ = _labels(3, ignore_all)
    extra = ({"class_weight": jl_module.EX_CLASS_WEIGHT} if kw else {})
    got = getattr(tl, name)(torch.from_numpy(logits[:, 12:19]),
                            torch.from_numpy(ex), **extra)
    want = getattr(jl, name)(jnp.asarray(logits[:, 12:19]),
                             jnp.asarray(ex), **extra)
    _close(got, want)


def test_ex_focal_topk_loss():
    """Top-20 % hard mining (no ignore handling, so no class 7)."""
    logits, _, ex, _ = _labels(4)
    ex = ex % 7
    got = tl.ex_focal_topk_loss(torch.from_numpy(logits[:, 12:19]),
                                torch.from_numpy(ex))
    want = jl.ex_focal_topk_loss(jnp.asarray(logits[:, 12:19]),
                                 jnp.asarray(ex))
    _close(got, want)


@pytest.mark.parametrize("pos_weight", [None, "au"])
def test_bce_with_logits_elementwise(pos_weight):
    logits, au, _, _ = _labels(5)
    pw = jl.AU_POS_WEIGHT if pos_weight else None
    got = tl.bce_with_logits(torch.from_numpy(logits[:, :12]),
                             torch.from_numpy(np.abs(au)), pw)
    want = jl.bce_with_logits(jnp.asarray(logits[:, :12]),
                              jnp.asarray(np.abs(au)), pw)
    _close(got, want)


@pytest.mark.parametrize("ignore_all", [False, True])
@pytest.mark.parametrize("suite", sorted(jl.SUITES))
def test_loss_suites(suite, ignore_all):
    """Every suite's get_{ex,au,va,mt}_loss (mt with and without
    normalize): the pos-weights, the VA weights 2:1 / 1:1, each model's
    EX and AU losses."""
    logits, au, ex, va = _labels(6, ignore_all)
    ts, js = tl.SUITES[suite], jl.SUITES[suite]
    assert ts.va_weight_v == js.va_weight_v
    t_in = torch.from_numpy(logits)
    j_in = jnp.asarray(logits)
    t_lab = {"AU": torch.from_numpy(au), "EX": torch.from_numpy(ex),
             "VA": torch.from_numpy(va)}
    j_lab = {k: jnp.asarray(v.numpy()) for k, v in t_lab.items()}
    for method, key in (("get_ex_loss", "EX"), ("get_au_loss", "AU"),
                        ("get_va_loss", "VA")):
        _close(getattr(ts, method)(t_in, t_lab[key]),
               getattr(js, method)(j_in, j_lab[key]))
    for normalize in (False, True):
        got = ts.get_mt_loss(t_in, t_lab, normalize=normalize)
        want = js.get_mt_loss(j_in, j_lab, normalize=normalize)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("name", ["au_bce_loss", "get_mt_loss"])
def test_loss_gradients(name):
    """d loss / d logits of the avformer suite, as autograd and jax.grad
    see them."""
    logits, au, ex, va = _labels(7)
    suite_t, suite_j = tl.SUITES["avformer"], jl.SUITES["avformer"]
    t_lab = {"AU": torch.from_numpy(au), "EX": torch.from_numpy(ex),
             "VA": torch.from_numpy(va)}
    j_lab = {k: jnp.asarray(v.numpy()) for k, v in t_lab.items()}
    if name == "au_bce_loss":
        def t_fn(x):
            return suite_t.get_au_loss(x, t_lab["AU"])

        def j_fn(x):
            return suite_j.get_au_loss(x, j_lab["AU"])
    else:
        def t_fn(x):
            lex, lau, lva = suite_t.get_mt_loss(x, t_lab)
            return 3.0 * lex + lau + lva

        def j_fn(x):
            lex, lau, lva = suite_j.get_mt_loss(x, j_lab)
            return 3.0 * lex + lau + lva
    x = torch.from_numpy(logits).requires_grad_()
    t_fn(x).backward()
    _close(x.grad, jax.grad(j_fn)(jnp.asarray(logits)), rtol=1e-4,
           atol=1e-6)


# -- metrics ------------------------------------------------------------------

def _sk(fn, *args, **kw):
    """sklearn's result or the type of its error; its zero-division
    warnings are expected here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn(*args, **kw)
        except ValueError as e:
            return type(e)


def _port(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("average", ["macro", "binary"])
def test_f1_and_accuracy_equal_sklearn(average):
    """Random label vectors (1-11 samples, absent classes, predictions of
    labels the truth lacks, all-equal vectors): the same float, or the
    same ValueError."""
    rs = np.random.RandomState(8)
    for _ in range(400):
        n = rs.randint(1, 12)
        k = 2 if average == "binary" else rs.randint(1, 8)
        dtype = np.float32 if average == "binary" else np.int64
        y_true = rs.randint(0, k, n).astype(dtype)
        y_pred = y_true.copy() if rs.rand() < 0.2 else \
            rs.randint(0, k, n).astype(dtype)
        assert _port(tm.f1_score, y_true, y_pred, average=average) == \
            _sk(sk_f1, y_true, y_pred, average=average)
        for normalize in (True, False):
            assert _port(tm.accuracy_score, y_true, y_pred,
                         normalize=normalize) == \
                _sk(sk_accuracy, y_true, y_pred, normalize=normalize)


@pytest.mark.parametrize("y_true,y_pred,average", [
    ([], [], "macro"),                       # empty: sklearn raises
    ([2, 3], [2, 3], "binary"),              # pos_label 1 absent
    ([0, 1, 2], [0, 1, 2], "binary"),        # multiclass under binary
    ([0.0, 0.0], [0.0, 0.0], "binary"),      # no positives: 0.0
    ([1.0, 1.0], [0.0, 0.0], "binary"),      # no predicted positives
    ([3, 3], [3, 3], "macro"),               # one class
])
def test_f1_edge_cases_equal_sklearn(y_true, y_pred, average):
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    assert _port(tm.f1_score, y_true, y_pred, average=average) == \
        _sk(sk_f1, y_true, y_pred, average=average)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_accumulators_equal_jax(seed):
    """Three eval batches through AccF1Metric, MultiLabelAccF1 (one AU
    column never predicted positive, one never labelled positive),
    CCCMetric and composite_scores: every number equal."""
    rs = np.random.RandomState(seed)
    port = (tm.AccF1Metric(7), tm.MultiLabelAccF1(-1), tm.CCCMetric(-5.0))
    ref = (jm.AccF1Metric(7), jm.MultiLabelAccF1(-1), jm.CCCMetric(-5.0))
    for _ in range(3):
        logits, au, ex, va = _labels(rs.randint(1 << 30))
        au[:, 0] = np.abs(au[:, 0])       # every column has a label
        pred_au = np.round(1 / (1 + np.exp(-logits[:, :12])))
        pred_au[:, 3] = 0.0
        au[:, 5] = np.minimum(au[:, 5], 0.0)
        ex[ex == 3] = 4                   # an absent EX class
        pred_ex = np.argmax(logits[:, 12:19], axis=1)
        for metrics in (port, ref):
            metrics[0].update(pred_ex, ex)
            metrics[1].update(pred_au, au)
            metrics[2].update(np.tanh(logits[:, 19:21]), va)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jm.composite_scores(*ref)
    assert tm.composite_scores(*port) == want


@pytest.mark.parametrize("n_valid", [0, 1, 2, 9])
def test_ccc_equals_jax(n_valid):
    rs = np.random.RandomState(9)
    y_true = rs.uniform(-1, 1, (9, 2)).astype(np.float32)
    y_true[n_valid:] = -5.0
    y_pred = rs.uniform(-1, 1, (9, 2)).astype(np.float32)
    assert tm.cccva(y_true, y_pred) == jm.cccva(y_true, y_pred)
    assert tm.ccc(y_true[:, 0], y_pred[:, 0]) == jm.ccc(y_true[:, 0],
                                                        y_pred[:, 0])
