"""auformer_torch phase-mel audio (ops/phase_mel.py) against the JAX package.

The window set is tests/test_phase_mel.py's: short windows at the video
start, mid-length ones, windows truncated by the end of an 11 s file, and
the hop-grid phases of 30 fps timestamps. The JAX side runs once per
module; both sides compute their DFTs in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auformer.ops import audio_host as jax_audio_host
from auformer.ops import phase_mel as jpm
from auformer_torch.ops import audio_host, phase_mel

SLEN = 441000
ATOL = 1e-4          # normalized units, as tests/test_phase_mel.py
POWER_TOL = dict(rtol=1e-5, atol=1e-4)   # mel power, values up to ~200
TS = np.array([120.0, 3000.0, 10500.0, 10800.0, 10950.0,
               320 * 1000 / 30, 321 * 1000 / 30, 322 * 1000 / 30,
               150 * 1000 / 30])


def _plan(ts, wav_len):
    offsets, want = jax_audio_host.audio_window_params_batch(ts)
    off_c = np.minimum(offsets, wav_len)
    n_valid = np.maximum(np.minimum(want, wav_len - off_c), 0)
    return (SLEN + off_c).astype(np.int32), n_valid.astype(np.int32)


def _wav_ext(wav):
    bucket = 60 * 44100
    ext = np.zeros(-(-len(wav) // bucket) * bucket + 2 * SLEN + 512,
                   np.float32)
    ext[SLEN:SLEN + len(wav)] = wav
    return ext


@pytest.fixture(scope="module")
def video():
    """The windows, their plan and JAX's table, edge frames and features."""
    wav = (np.random.RandomState(3).randn(11 * 44100) * 0.1
           ).astype(np.float32)
    starts, n_valid = _plan(TS, len(wav))
    phases, base, phase_sel = jpm.phase_plan(
        starts.astype(np.int64) - SLEN, n_valid)
    ext = _wav_ext(wav)
    j = {k: jnp.asarray(v) for k, v in dict(
        ext=ext, starts=starts, n_valid=n_valid, phases=phases, base=base,
        phase_sel=phase_sel).items()}
    table = jpm.phase_mel_table(j["ext"], j["phases"])
    edges = jpm._edge_frames(j["ext"], j["starts"], j["n_valid"], 64)
    feats = {tm: np.asarray(jpm.phase_window_features(
        j["ext"], table, j["starts"], j["n_valid"], j["base"],
        j["phase_sel"], time_major=tm)) for tm in (False, True)}
    return dict(wav=wav, ext=ext, starts=starts, n_valid=n_valid,
                phases=phases, base=base, phase_sel=phase_sel,
                table=np.asarray(table),
                edges=[np.asarray(e) for e in edges], feats=feats)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def port_table(video):
    return phase_mel.phase_mel_table(_t(video["ext"]), video["phases"])


def test_audio_window_params_match_jax():
    ts = np.concatenate([TS, np.random.RandomState(0).uniform(0, 9e5, 64)])
    got = audio_host.audio_window_params_batch(ts)
    want = jax_audio_host.audio_window_params_batch(ts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for t in ts[:12]:
        assert (audio_host.audio_window_params(float(t))
                == jax_audio_host.audio_window_params(float(t)))


PLAN_CASES = {
    "30fps": (TS, 11 * 44100, 8),
    "30fps_long": (np.arange(2100) * 1000 / 30, 70 * 44100, 8),
    "scattered": (np.array([5100.0 + 17.3 * k for k in range(12)]),
                  11 * 44100, 8),           # > 8 phases: None
    "forced": (TS, 11 * 44100, 0),          # max_phases 0 forces None
    "no_audio": (np.array([100.0, 200.0]), 0, 8),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_phase_plan_matches_jax(case):
    ts, wav_len, max_phases = PLAN_CASES[case]
    starts, n_valid = _plan(ts, wav_len)
    offsets = starts.astype(np.int64) - SLEN
    got = phase_mel.phase_plan(offsets, n_valid, max_phases)
    want = jpm.phase_plan(offsets, n_valid, max_phases)
    assert (got is None) == (want is None)
    assert (got is None) == (case in ("scattered", "forced"))
    if want is not None:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_phase_mel_table_matches_jax(video, port_table):
    assert port_table.shape == video["table"].shape
    np.testing.assert_allclose(port_table.numpy(), video["table"],
                               **POWER_TOL)


def test_edge_frames_match_jax(video):
    got = phase_mel._edge_frames(_t(video["ext"]), _t(video["starts"]),
                                 _t(video["n_valid"]), 64)
    for g, w in zip(got, video["edges"]):
        np.testing.assert_allclose(g.numpy(), w, **POWER_TOL)


def test_edge_frames_clamp_as_dynamic_slice_does():
    """Starts past the end of a short buffer: jax.lax.dynamic_slice clamps
    the start frame's and the end frame's slices; the port clamps the same
    way."""
    buf = np.random.RandomState(1).randn(5000).astype(np.float32)
    starts = np.array([4500, 0, 4000, 4990], np.int32)
    n_valid = np.array([2000, 600, 900, 1400], np.int32)
    want = jpm._edge_frames(jnp.asarray(buf), jnp.asarray(starts),
                            jnp.asarray(n_valid), 64)
    got = phase_mel._edge_frames(_t(buf), _t(starts), _t(n_valid), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("time_major", [False, True])
def test_phase_window_features_match_jax(video, port_table, time_major):
    got = phase_mel.phase_window_features(
        _t(video["ext"]), port_table, _t(video["starts"]),
        _t(video["n_valid"]), _t(video["base"]), _t(video["phase_sel"]),
        time_major=time_major).numpy()
    want = video["feats"][time_major]
    n = len(TS)
    assert got.shape == want.shape == ((n, 1001, 64, 1) if time_major
                                       else (n, 1, 64, 1001))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_phase_window_features_match_reference_host(video, port_table):
    """The port's features equal the reference's per-window host mel
    (aff2compdataset.py:227-247 via the JAX package's audio_host)."""
    got = phase_mel.phase_window_features(
        _t(video["ext"]), port_table, _t(video["starts"]),
        _t(video["n_valid"]), _t(video["base"]),
        _t(video["phase_sel"])).numpy()
    for i in range(len(TS)):
        o, nv = int(video["starts"][i]) - SLEN, int(video["n_valid"][i])
        ref = jax_audio_host.reference_audio_features(
            video["wav"][o:o + nv][None], 10, 10e-3, SLEN, 64)[0]
        np.testing.assert_allclose(got[i], ref, rtol=1e-4, atol=ATOL)


def test_table_of_distinct_phases_equals_padded_rows(video, port_table):
    """The sweep passes only the plan's distinct phases; their tables are
    the padded plan's first rows."""
    distinct = np.unique(video["phases"])
    got = phase_mel.phase_mel_table(_t(video["ext"]), distinct)
    torch.testing.assert_close(got, port_table[:len(distinct)], rtol=0,
                               atol=0)
