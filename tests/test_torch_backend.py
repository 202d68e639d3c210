"""The port's scoring back end (asv_subtools_tpu_torch/backend and the
Kaldi object I/O of asv_subtools_tpu_torch/io) against the JAX package's,
on the CPU, on inputs drawn with numpy from a seed.

* The numpy modules (Kaldi I/O, trials, metrics, transforms, PLDA and its
  I/O, adaptation, the host S-norm/AS-norm, classifiers, fusion, figure,
  i-vectors) are copies that run the same numpy calls in the same order:
  held bit for bit (``assert_array_equal``, or equal bytes for files).
  Files each side writes are read by the other.
* ``asnorm_device`` and ``llr_matrix_device`` on ``device="cpu"``: against
  JAX's on the same f32 inputs at atol 1e-5, rtol 1e-5, and against the
  f64 host versions at the tolerances of tests/test_backend_scale.py
  (AS-norm rtol 2e-3, atol 2e-4; PLDA 2e-3), at E=100, T=130, C=600.
* ``ScoreSets`` on ``device="cpu"`` against JAX's for each classifier: the
  cosine matrices at atol 1e-6, the PLDA paths bit for bit, EER and minDCF
  within one target trial (1 / number of target trials) of JAX's, since
  the f32 products of the two sides may round near-tied trials apart.
* Without a card, ``ScoreSets``, ``asnorm_device`` and
  ``llr_matrix_device`` raise unless a device is given.
"""

import struct
import sys

import numpy as np
import pytest
import torch

import asv_subtools_tpu.backend as J
import asv_subtools_tpu.io.kaldi as JK
import asv_subtools_tpu_torch.backend as P
import asv_subtools_tpu_torch.io.kaldi as PK
from asv_subtools_tpu.backend import ivector as J_iv
from asv_subtools_tpu.backend import plda as J_plda
from asv_subtools_tpu_torch.backend import ivector as P_iv
from asv_subtools_tpu_torch.backend import plda as P_plda

torch.set_num_threads(2)

SIDES = [(P, J), (J, P)]  # (writer, reader)
SIDE_IDS = ["port-writes", "jax-writes"]
KIO = [(PK, JK), (JK, PK)]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _plda_eq(a, b):
    _eq(a.mean, b.mean)
    _eq(a.transform, b.transform)
    _eq(a.psi, b.psi)


def _two_cov_eq(a, b):
    _eq(a.mean, b.mean)
    _eq(a.within_var, b.within_var)
    _eq(a.between_var, b.between_var)


def synth_data(rng, n_spk=40, n_utt=10, dim=16, within_scale=None):
    """PLDA generative model data (tests/test_backend.py)."""
    if within_scale is None:
        within_scale = np.linspace(0.2, 2.0, dim)
    spk_means = rng.normal(size=(n_spk, dim)) * 1.5
    ids = np.repeat(np.arange(n_spk), n_utt)
    noise = rng.normal(size=(n_spk * n_utt, dim)) * np.sqrt(within_scale)
    return spk_means[ids] + noise, ids


def _rand_plda(mod, rng, d=8):
    a = rng.normal(size=(d, d))
    return mod.Plda(mean=rng.normal(size=d), transform=a + d * np.eye(d),
                    psi=np.sort(rng.uniform(0.5, 5.0, size=d))[::-1].copy())


# --------------------------------------------------------------------------
# 1. Kaldi object files, tokens, alignments
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vec_f32", "vec_f64", "vec_text", "mat_f32", "mat_f64", "mat_text",
                                  "mat_one_row_text"])
@pytest.mark.parametrize("w,r", KIO, ids=SIDE_IDS)
def test_kaldi_object_files_cross_read(tmp_path, w, r, kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=17) if kind.startswith("vec") else rng.normal(size=(1 if "one_row" in kind else 5, 9))
    if "f32" in kind:
        x = x.astype(np.float32)
    binary = "text" not in kind
    path, jpath = str(tmp_path / "a"), str(tmp_path / "b")
    write = w.write_vec if kind.startswith("vec") else w.write_mat_file
    other = r.write_vec if kind.startswith("vec") else r.write_mat_file
    write(path, x, binary=binary)
    other(jpath, x, binary=binary)
    with open(path, "rb") as f1, open(jpath, "rb") as f2:
        assert f1.read() == f2.read()
    read = r.read_vec if kind.startswith("vec") else r.read_mat_file
    mine = w.read_vec if kind.startswith("vec") else w.read_mat_file
    got = read(path)
    _eq(got, mine(path))
    assert got.dtype == mine(path).dtype and got.shape == x.shape
    if binary:
        _eq(got, x)
    else:
        np.testing.assert_allclose(got, x, rtol=1e-12)
    _eq(read(f"cat {path} |"), got)  # a pipe cannot seek: the binary/text sniff must not


@pytest.mark.parametrize("w,r", KIO, ids=SIDE_IDS)
def test_tokens_and_bodies(tmp_path, w, r):
    path = str(tmp_path / "tok")
    m = np.arange(6, dtype=np.float64).reshape(2, 3)
    with open(path, "wb") as f:
        w.write_token(f, "<Tok>")
        w._write_vec_body(f, np.arange(4, dtype=np.float32))
        w._write_mat_body(f, m)
        w.write_token(f, "</Tok>")
    with open(path, "rb") as f:
        assert r.read_token(f) == "<Tok>"
        assert f.read(3) == b"FV "
        n = r._read_int32(f)
        _eq(np.frombuffer(f.read(4 * n), np.float32), np.arange(4, dtype=np.float32))
        _eq(r._read_mat_body(f, f.read(3), None), m)
        r.expect_token(f, "</Tok>")
        with pytest.raises(EOFError):
            r.read_token(f)
    with open(path, "rb") as f:
        with pytest.raises(ValueError, match="expected Kaldi token"):
            r.expect_token(f, "<Other>")


def test_read_text_block_and_head():
    text = "junk [ 1 2 3\n 4 5 6 ] tail [ 7 ]"
    assert PK._read_text_block(text) == JK._read_text_block(text) == [[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], [[7.0]]]
    import io
    assert PK._read_head(io.BytesIO(b"\x00Bxyz")) == JK._read_head(io.BytesIO(b"\x00Bxyz")) == (True, b"\x00B")
    assert PK._read_head(io.BytesIO(b" [ 1 ]")) == (False, b" [")


@pytest.mark.parametrize("w,r", KIO, ids=SIDE_IDS)
def test_alignments_cross_read(tmp_path, w, r):
    ali = np.random.default_rng(3).integers(0, 200, size=37).astype(np.int32)
    path, other = str(tmp_path / "ali.ark"), str(tmp_path / "ali2.ark")
    with open(path, "wb") as f:
        off = w.write_vec_int(f, ali, "utt1")
    with open(other, "wb") as f:
        assert r.write_vec_int(f, ali, "utt1") == off
    with open(path, "rb") as f1, open(other, "rb") as f2:
        assert f1.read() == f2.read()
    rx = f"{path}:{off}"
    _eq(r.read_ali(rx), ali)
    _eq(r.read_ali(rx, row_range=(3, 11)), ali[3:11])
    _eq(w.read_ali(rx), r.read_ali(rx))
    assert dict(r.read_vec_int_ark(path)).keys() == {"utt1"}
    # the single-column float matrix branch
    col = str(tmp_path / "col.ark")
    with open(col, "wb") as f:
        off = w.write_mat(f, ali[:, None].astype(np.float32), "utt2")
    got = r.read_ali(f"{col}:{off}")
    _eq(got, ali)
    _eq(got, w.read_ali(f"{col}:{off}"))


def test_io_exports():
    import asv_subtools_tpu.io as jio
    import asv_subtools_tpu_torch.io as pio

    jax_names = {n for n in dir(jio) if not n.startswith("_") and n not in ("kaldi", "wav")}
    assert jax_names <= set(pio.__all__)
    for name in ("read_token", "write_token", "expect_token", "read_vec", "write_vec", "read_mat_file",
                 "write_mat_file", "read_ali", "write_vec_int"):
        assert getattr(pio, name) is getattr(PK, name)


# --------------------------------------------------------------------------
# 2. trials
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w,r", SIDES, ids=SIDE_IDS)
def test_trials_and_scores_files(tmp_path, w, r):
    rng = np.random.default_rng(0)
    e_keys = [f"e{i}" for i in rng.integers(0, 5, 30)]
    t_keys = [f"t{i}" for i in rng.integers(0, 7, 30)]
    labels = rng.integers(0, 2, 30)
    tr_path, tr_other = str(tmp_path / "trials"), str(tmp_path / "trials2")
    w.Trials(e_keys, t_keys, labels).write(tr_path)
    r.Trials(e_keys, t_keys, labels).write(tr_other)
    assert open(tr_path).read() == open(tr_other).read()
    a, b = r.Trials.read(tr_path), w.Trials.read(tr_path)
    assert a.enroll_keys == b.enroll_keys == e_keys and a.test_keys == t_keys
    _eq(a.labels, b.labels)
    mat = rng.normal(size=(5, 7))
    ei, ti = {f"e{i}": i for i in range(5)}, {f"t{i}": i for i in range(7)}
    _eq(a.select_scores(mat, ei, ti), b.select_scores(mat, ei, ti))
    scores = a.select_scores(mat, ei, ti)
    w.write_scores(str(tmp_path / "s"), a, scores)
    r.write_scores(str(tmp_path / "s2"), a, scores)
    assert open(tmp_path / "s").read() == open(tmp_path / "s2").read()
    (ta, sa), (tb, sb) = r.read_scores(str(tmp_path / "s")), w.read_scores(str(tmp_path / "s"))
    assert ta.enroll_keys == tb.enroll_keys and ta.labels is None and tb.labels is None
    _eq(sa, sb)
    from asv_subtools_tpu.backend import trials as jt
    from asv_subtools_tpu_torch.backend import trials as pt

    tabs = [m.scores_to_table(a, scores) for m in (jt, pt)]
    assert tabs[0][:2] == tabs[1][:2]
    _eq(tabs[0][2], tabs[1][2])
    back = [m.table_to_scores(*tabs[0]) for m in (jt, pt)]
    assert back[0][0].enroll_keys == back[1][0].enroll_keys and back[0][0].test_keys == back[1][0].test_keys
    _eq(back[0][1], back[1][1])


# --------------------------------------------------------------------------
# 3. metrics
# --------------------------------------------------------------------------

def _scores(seed, n=400, ties=False):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(int)
    scores = rng.normal(size=n) + 1.5 * labels
    if ties:
        scores = np.round(scores, 1)
    return scores, labels


@pytest.mark.parametrize("fn", ["roc_curve", "compute_eer", "compute_eer_bosaris", "compute_eer_kaldi",
                                "compute_min_dcf"])
@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False)])
def test_verification_metrics(fn, seed, ties):
    s, l = _scores(seed, ties=ties)
    a, b = getattr(P, fn)(s, l), getattr(J, fn)(s, l)
    for x, y in zip(a, b):
        _eq(x, y)
    if fn == "compute_min_dcf":
        _eq(P.compute_min_dcf(s, l, p_target=0.05, c_fa=2.0), J.compute_min_dcf(s, l, p_target=0.05, c_fa=2.0))


@pytest.mark.parametrize("unknown", [False, True])
def test_cavg(unknown):
    rng = np.random.default_rng(3)
    pairs = [(int(c), int(t), float(rng.normal() + 2.0 * (c == t)))
             for c in range(4) for t in rng.integers(-1 if unknown else 0, 4, 25)]
    a = P.compute_cavg(pairs, 4, unknown_as_nontarget=unknown)
    b = J.compute_cavg(pairs, 4, unknown_as_nontarget=unknown)
    assert a == b


def test_min_tdcf_and_retrieval_map():
    rng = np.random.default_rng(4)
    asv_l = rng.integers(-1, 2, 300)
    asv_s = rng.normal(size=300) + 2.0 * (asv_l == 1) - 1.0 * (asv_l == -1)
    cm_l = rng.integers(0, 2, 300)
    cm_s = rng.normal(size=300) + 1.5 * cm_l
    assert P.compute_min_tdcf(asv_s, asv_l, cm_s, cm_l) == J.compute_min_tdcf(asv_s, asv_l, cm_s, cm_l)
    sc = rng.normal(size=(6, 40))
    rel = rng.random((6, 40)) < 0.2
    for top_n in (5, 10, 60):
        assert P.retrieval_map(sc, rel, top_n) == J.retrieval_map(sc, rel, top_n)


# --------------------------------------------------------------------------
# 4. transforms
# --------------------------------------------------------------------------

def test_transforms():
    rng = np.random.default_rng(6)
    x, ids = synth_data(rng, n_spk=12, n_utt=7, dim=10)
    for a, b in zip(P.speaker_means(x, ids), J.speaker_means(x, ids)):
        _eq(a, b)
    _eq(P.global_mean(x), J.global_mean(x))
    _eq(P.length_norm(x), J.length_norm(x))
    _eq(P.length_norm(x, scale_to_sqrt_dim=False), J.length_norm(x, scale_to_sqrt_dim=False))
    lda = P.train_lda(x, ids, 6)
    _eq(lda, J.train_lda(x, ids, 6))
    mean = x.mean(0)
    _eq(P.apply_lda(x, lda, mean), J.apply_lda(x, lda, mean))
    _eq(P.apply_lda(x, lda), J.apply_lda(x, lda))
    for cls, kw in [("ZCAWhitening", {}), ("PCAWhitening", {}), ("PCAWhitening", {"dim": 4}),
                    ("PCAWhitening", {"normalize_variance": True})]:
        a, b = getattr(P, cls)(**kw).fit(x), getattr(J, cls)(**kw).fit(x)
        _eq(a.transform(x), b.transform(x))
        _eq(a.transform(x.astype(np.float32)), b.transform(x.astype(np.float32)))
    chains = [m.TransformChain().add("mean", lambda v: v - mean).add("norm", m.length_norm) for m in (P, J)]
    assert repr(chains[0]) == repr(chains[1]) == "mean-norm" and repr(P.TransformChain()) == "(empty)"
    _eq(chains[0].apply(x), chains[1].apply(x))


# --------------------------------------------------------------------------
# 5. PLDA on the host, its files, and llr_matrix_device
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plda_pair():
    rng = np.random.default_rng(7)
    x, ids = synth_data(rng, n_spk=30, n_utt=6, dim=12)
    ids = ids.copy()
    ids[:9] = 0  # classes of several sizes: EM groups classes by count
    weights = rng.uniform(0.5, 1.5, size=len(np.unique(ids)))
    sp, sj = P.PldaStats.from_vectors(x, ids), J.PldaStats.from_vectors(x, ids)
    for f in ("sum", "offset_scatter", "class_means", "class_counts", "class_weights"):
        _eq(getattr(sp, f), getattr(sj, f))
    assert (sp.dim, sp.num_classes, sp.class_weight, sp.example_weight) == \
        (sj.dim, sj.num_classes, sj.class_weight, sj.example_weight)
    swp, swj = P.PldaStats.from_vectors(x, ids, weights), J.PldaStats.from_vectors(x, ids, weights)
    _eq(swp.offset_scatter, swj.offset_scatter)
    pp, pj = P.estimate_plda(sp, 6), J.estimate_plda(sj, 6)
    _plda_eq(pp, pj)
    return pp, pj, x


def test_plda_scoring(plda_pair):
    pp, pj, x = plda_pair
    rng = np.random.default_rng(8)
    e, t = rng.normal(size=(9, 12)), rng.normal(size=(11, 12))
    counts = rng.integers(1, 5, 9)
    for kw in ({}, {"num_examples": counts}, {"normalize_length": False}, {"simple_length_norm": True}):
        _eq(pp.transform_vectors(e, **kw), pj.transform_vectors(e, **kw))
    ep, tp = pp.transform_vectors(e, num_examples=counts), pp.transform_vectors(t)
    _eq(pp.llr_matrix(ep, tp), pj.llr_matrix(ep, tp))
    _eq(pp.llr_matrix(ep, tp, counts), pj.llr_matrix(ep, tp, counts))
    _eq(P.plda_score_trials(pp, e, t, counts), J.plda_score_trials(pj, e, t, counts))
    a, b = P.Plda(pp.mean, pp.transform.copy(), pp.psi.copy()), J.Plda(pj.mean, pj.transform.copy(), pj.psi.copy())
    a.smooth_within_class_covariance(0.1)
    b.smooth_within_class_covariance(0.1)
    _plda_eq(a, b)
    assert a.dim == 12


def _golden_binary_plda(mean, transform, psi) -> bytes:
    """Kaldi's binary Plda::Write, transcribed with struct.pack
    (tests/test_kaldi_plda_io.py)."""
    out = b"\x00B<Plda> "
    out += b"DV \x04" + struct.pack("<i", len(mean)) + np.asarray(mean, "<f8").tobytes()
    out += b"DM \x04" + struct.pack("<i", transform.shape[0]) + b"\x04" + struct.pack("<i", transform.shape[1])
    out += np.asarray(transform, "<f8").tobytes()
    out += b"DV \x04" + struct.pack("<i", len(psi)) + np.asarray(psi, "<f8").tobytes()
    return out + b"</Plda> "


@pytest.mark.parametrize("form", ["golden", "binary", "text", "two_cov_ark"])
@pytest.mark.parametrize("w,r", SIDES, ids=SIDE_IDS)
def test_plda_files_cross_read(tmp_path, w, r, form):
    rng = np.random.default_rng(2)
    ref = _rand_plda(w, rng)
    path, other = str(tmp_path / "plda"), str(tmp_path / "plda2")
    if form == "golden":
        with open(path, "wb") as f:
            f.write(_golden_binary_plda(ref.mean, ref.transform, ref.psi))
    elif form in ("binary", "text"):
        w.write_kaldi_plda(ref, path, binary=form == "binary")
        r.write_kaldi_plda(r.Plda(ref.mean, ref.transform, ref.psi), other, binary=form == "binary")
        assert open(path, "rb").read() == open(other, "rb").read()
        if form == "binary":
            assert open(path, "rb").read() == _golden_binary_plda(ref.mean, ref.transform, ref.psi)
    else:
        a = rng.normal(size=(8, 8))
        b = rng.normal(size=(8, 8))
        within, between = a @ a.T + 8 * np.eye(8), b @ b.T + np.eye(8)
        w.write_two_cov_ark(ref.mean, within, between, path)
        r.write_two_cov_ark(ref.mean, within, between, other)
        assert open(path, "rb").read() == open(other, "rb").read()
        for x, y in zip(r.read_two_cov_ark(path), w.read_two_cov_ark(path)):
            _eq(x, y)
        _plda_eq(r.plda_from_two_cov(ref.mean, within, between), w.plda_from_two_cov(ref.mean, within, between))
    got, mine = r.read_kaldi_plda(path), w.read_kaldi_plda(path)
    _plda_eq(got, mine)
    if form in ("golden", "binary"):
        _plda_eq(got, ref)
    if form == "text":
        _plda_eq(r.read_kaldi_plda_text(path), w.read_kaldi_plda_text(path))
        w.write_kaldi_plda_text(ref, other)
        assert open(path).read() == open(other).read()


@pytest.mark.parametrize("d", [16, 64])
def test_llr_matrix_device_against_jax_and_f64(d):
    """At E=100, T=130 with a PLDA from estimate_plda (5 EM iterations,
    tests/test_backend_scale.py:84-105 at a reduced size). Both device
    functions are f32: the LLR is the difference of two log-likelihoods
    of magnitude about M_LOG_2PI * D, so each side sits a few f32 steps of
    that magnitude from the f64 result (measured at D=64: JAX 2.6e-5, the
    port 2.9e-5). At D=16 those steps are under 1e-5 and the port is held
    to JAX's at atol 1e-5, rtol 1e-5; at D=64 it is held to the f64
    matrix at 2e-3 and to no more than twice JAX's own distance from it."""
    rng = np.random.default_rng(1)
    n_spk, per = 60, 8
    centroids = rng.normal(size=(n_spk, d))
    vecs = (centroids[:, None, :] + 0.4 * rng.normal(size=(n_spk, per, d))).reshape(-1, d)
    plda = P.estimate_plda(P.PldaStats.from_vectors(vecs, np.repeat(np.arange(n_spk), per)), num_em_iters=5)
    enroll = (centroids[rng.integers(0, n_spk, 100)] + 0.5 * rng.normal(size=(100, d))).astype(np.float32)
    test = (centroids[rng.integers(0, n_spk, 130)] + 0.5 * rng.normal(size=(130, d))).astype(np.float32)
    counts = rng.integers(1, 4, 100)
    for c in (None, counts):
        got = P_plda.llr_matrix_device(plda, enroll, test, c, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
        jax_out = np.asarray(J_plda.llr_matrix_device(plda, enroll, test, c))
        host = plda.llr_matrix(enroll, test, c)
        np.testing.assert_allclose(got.numpy(), host, rtol=2e-3, atol=2e-3)
        if d == 16:
            np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got.numpy() - host).max() <= 2 * np.abs(jax_out - host).max()
    # tensors in, as numpy
    again = P_plda.llr_matrix_device(plda, torch.from_numpy(enroll), torch.from_numpy(test), counts, device="cpu")
    _eq(again.numpy(), got.numpy())


# --------------------------------------------------------------------------
# 6. adaptation
# --------------------------------------------------------------------------

def test_adaptation(plda_pair):
    pp, pj, _ = plda_pair
    rng = np.random.default_rng(15)
    adapt = rng.normal(size=(200, 12)) * 2.0 + 1.5
    _plda_eq(P.adapt_plda_unsupervised(pp, adapt), J.adapt_plda_unsupervised(pj, adapt))
    _plda_eq(P.adapt_plda_unsupervised(pp, adapt, mean_diff_scale=0.5, within_covar_scale=0.1),
             J.adapt_plda_unsupervised(pj, adapt, mean_diff_scale=0.5, within_covar_scale=0.1))
    tp, tj = P.TwoCovPlda.from_scoring_form(pp), J.TwoCovPlda.from_scoring_form(pj)
    _two_cov_eq(tp, tj)
    _plda_eq(tp.to_scoring_form(), tj.to_scoring_form())
    cp, cj = P.adapt_plda_coral(tp, adapt), J.adapt_plda_coral(tj, adapt)
    _two_cov_eq(cp, cj)
    _two_cov_eq(P.adapt_plda_coral_plus(tp, adapt), J.adapt_plda_coral_plus(tj, adapt))
    _two_cov_eq(P.adapt_plda_lip(tp, cp, 0.7), J.adapt_plda_lip(tj, cj, 0.7))
    _two_cov_eq(P.adapt_plda_lip_reg(tp, cp), J.adapt_plda_lip_reg(tj, cj))
    _two_cov_eq(P.adapt_plda_cip(tp, cp, adapt, 0.7), J.adapt_plda_cip(tj, cj, adapt, 0.7))
    _two_cov_eq(P.adapt_plda_cip_reg(tp, cp, adapt), J.adapt_plda_cip_reg(tj, cj, adapt))


# --------------------------------------------------------------------------
# 7. score normalization and cosine scoring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("top_n,cross", [(10, False), (50, False), (10, True), (80, True)])
def test_host_score_norm(top_n, cross):
    rng = np.random.default_rng(12)
    raw, ec, tc = rng.normal(size=(4, 6)), rng.normal(size=(4, 50)), rng.normal(size=(6, 50))
    _eq(P.asnorm(raw, ec, tc, top_n=top_n, cross_select=cross), J.asnorm(raw, ec, tc, top_n=top_n, cross_select=cross))
    _eq(P.snorm(raw, ec, tc), J.snorm(raw, ec, tc))


def _cohort_scores(e_n, t_n, c_n, d=32, seed=0):
    rng = np.random.default_rng(seed)
    n_spk = 50
    centroids = rng.normal(size=(n_spk, d)).astype(np.float32)

    def draw(n):
        return (centroids[rng.integers(0, n_spk, n)] + 0.5 * rng.normal(size=(n, d))).astype(np.float32)

    enroll, test, cohort = (torch.from_numpy(draw(n)) for n in (e_n, t_n, c_n))
    return tuple(P.cosine_score_matrix(a, b).numpy() for a, b in ((enroll, test), (enroll, cohort), (test, cohort)))


def test_asnorm_device_against_jax_and_f64():
    """E=100, T=130, C=600, top_n=64 (the shape of
    tests/test_backend_scale.py:76-83 with a smaller cohort)."""
    raw, ec, tc = _cohort_scores(100, 130, 600)
    got = P.asnorm_device(raw, ec, tc, top_n=64, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (100, 130) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(J.asnorm_device(raw, ec, tc, top_n=64)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), J.asnorm(raw, ec, tc, top_n=64), rtol=2e-3, atol=2e-4)
    # f64 tensors in: cast to f32 as JAX casts
    got64 = P.asnorm_device(*(torch.from_numpy(m.astype(np.float64)) for m in (raw, ec, tc)), top_n=64, device="cpu")
    _eq(got64.numpy(), got.numpy())


def test_asnorm_device_whole_cohort():
    """top_n >= C: every cohort score enters, as S-norm."""
    raw, ec, tc = _cohort_scores(7, 9, 40, seed=3)
    for top_n in (40, 300):
        got = P.asnorm_device(raw, ec, tc, top_n=top_n, device="cpu").numpy()
        np.testing.assert_allclose(got, np.asarray(J.asnorm_device(raw, ec, tc, top_n=top_n)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, P.snorm(raw, ec, tc), rtol=2e-3, atol=2e-4)


def test_asnorm_device_mesh_matches_jax():
    """asnorm_device(mesh=...) (before ROADMAP item 5 was ported it raised)
    on a mesh of one process (a one-process gloo group) against JAX's on a
    one-device mesh and against the unsharded call; the 2- and 4-rank
    runs are tests/test_torch_distributed.py's."""
    import socket

    import jax

    from asv_subtools_tpu.parallel import make_mesh as jax_make_mesh
    from asv_subtools_tpu_torch import parallel

    raw, ec, tc = _cohort_scores(4, 5, 20, seed=4)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    parallel.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="gloo")
    try:
        got = P.asnorm_device(raw, ec, tc, top_n=8, mesh=parallel.make_mesh(), device="cpu").numpy()
    finally:
        torch.distributed.destroy_process_group()
    want = np.asarray(J.asnorm_device(raw, ec, tc, top_n=8, mesh=jax_make_mesh(devices=jax.devices()[:1])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, P.asnorm_device(raw, ec, tc, top_n=8, device="cpu").numpy(), rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_cosine_score_matrix(normalize):
    rng = np.random.default_rng(9)
    e, t = rng.normal(size=(20, 24)) * 3, rng.normal(size=(30, 24))
    e[3] = 0.0  # the 1e-12 clamp
    got = P.cosine_score_matrix(torch.from_numpy(e), torch.from_numpy(t), normalize=normalize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(J.cosine_score_matrix(e, t, normalize=normalize)),
                               rtol=0, atol=1e-6 * (1 if normalize else 50))


# --------------------------------------------------------------------------
# 8. classifiers, fusion, figure
# --------------------------------------------------------------------------

def _classes(seed=0, n_class=4, per_class=30, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_class, d)) * 3.0
    y = np.repeat(np.arange(n_class), per_class)
    return centers[y] + rng.normal(size=(len(y), d)), y


@pytest.mark.parametrize("fn", ["train_svm", "train_logistic_regression"])
def test_linear_classifiers(fn):
    pytest.importorskip("sklearn")
    x, y = _classes()
    a, b = getattr(P, fn)(x, y, c=0.5), getattr(J, fn)(x, y, c=0.5)
    _eq(a.weight, b.weight)
    _eq(a.bias, b.bias)
    _eq(a.classes, b.classes)
    _eq(a.scores(x), b.scores(x))
    _eq(a.predict(x), b.predict(x))
    xb, yb = x[y < 2], y[y < 2]  # binary: two-class scores from one row
    _eq(getattr(P, fn)(xb, yb).scores(xb), getattr(J, fn)(xb, yb).scores(xb))


def test_gmms():
    x, y = _classes(1)
    gp = {f"l{c}": P.train_diag_gmm(x[y == c], num_components=3, num_iters=5, seed=c) for c in range(4)}
    gj = {f"l{c}": J.train_diag_gmm(x[y == c], num_components=3, num_iters=5, seed=c) for c in range(4)}
    for k in gp:
        for f in ("weights", "means", "vars"):
            _eq(getattr(gp[k], f), getattr(gj[k], f))
        _eq(gp[k].log_likelihood(x), gj[k].log_likelihood(x))
        _eq(gp[k].responsibilities(x), gj[k].responsibilities(x))
    (sp, lp), (sj, lj) = P.gmm_lid_scores(gp, x), J.gmm_lid_scores(gj, x)
    _eq(sp, sj)
    assert list(lp) == list(lj)
    from asv_subtools_tpu.backend.classifiers import train_diag_gmm_mmi as jmmi
    from asv_subtools_tpu_torch.backend.classifiers import train_diag_gmm_mmi as pmmi

    mp, mj = pmmi(gp, x, y, num_iters=2), jmmi(gj, x, y, num_iters=2)
    for k in mp:
        _eq(mp[k].means, mj[k].means)
        _eq(mp[k].vars, mj[k].vars)


@pytest.mark.parametrize("fn", ["lda_fusion", "logistic_fusion", "svm_fusion", "greedy_fusion", "weight_fusion"])
def test_fusion(fn):
    if fn in ("logistic_fusion", "svm_fusion"):
        pytest.importorskip("sklearn")
    rng = np.random.default_rng(10)
    labels = (rng.random(200) < 0.4).astype(int)
    dev = [rng.normal(size=200) + k * labels for k in (1.0, 2.0, 0.5)]
    ev = [rng.normal(size=50) for _ in range(3)]
    if fn == "weight_fusion":
        _eq(P.weight_fusion(dev, [0.2, 0.5, 0.3]), J.weight_fusion(dev, [0.2, 0.5, 0.3]))
        return
    a, b = getattr(P, fn)(dev, labels, ev), getattr(J, fn)(dev, labels, ev)
    for x, y in zip(a, b):
        _eq(x, y)


def test_figure(tmp_path):
    s, l = _scores(11)
    for x, y in zip(P.det_curve_points(s, l), J.det_curve_points(s, l)):
        _eq(x, y)
    pytest.importorskip("matplotlib")
    P.plot_det([("a", s, l), ("b", s * 0.5, l)], str(tmp_path / "det.png"))
    P.plot_score_distribution(s, l, str(tmp_path / "dist.png"))
    assert (tmp_path / "det.png").stat().st_size > 0 and (tmp_path / "dist.png").stat().st_size > 0


# --------------------------------------------------------------------------
# 9. i-vectors
# --------------------------------------------------------------------------

def test_ivector_chain():
    rng = np.random.default_rng(0)
    d, r_true = 6, 3
    proj = rng.normal(size=(r_true, d))
    utts = []
    for _ in range(6):
        w = rng.normal(size=r_true)
        utts += [w @ proj + rng.normal(size=(int(rng.integers(40, 80)), d)) for _ in range(3)]
    ubm_p = P_iv.train_ubm(np.concatenate(utts), num_components=4, num_iters=4)
    ubm_j = J_iv.train_ubm(np.concatenate(utts), num_components=4, num_iters=4)
    _eq(ubm_p.means, ubm_j.means)
    st_p, st_j = P_iv.collect_stats(ubm_p, utts), J_iv.collect_stats(ubm_j, utts)
    _eq(st_p.n, st_j.n)
    _eq(st_p.f, st_j.f)
    ex_p = P_iv.train_ivector_extractor(ubm_p, st_p, ivector_dim=4, num_iters=3)
    ex_j = J_iv.train_ivector_extractor(ubm_j, st_j, ivector_dim=4, num_iters=3)
    _eq(ex_p.t, ex_j.t)
    assert ex_p.ivector_dim == 4
    _eq(ex_p.extract(st_p), ex_j.extract(st_j))
    _eq(ex_p.extract_from_frames(utts[:4]), ex_j.extract_from_frames(utts[:4]))


def _kaldi_ie(mod, rng, k=4, d=6, r=3):
    m = rng.normal(size=(k, d, r))
    s = rng.normal(size=(k, d, d))
    return mod.KaldiIvectorExtractor(m=m, sigma_inv=np.einsum("kde,kfe->kdf", s, s) + 2 * np.eye(d)[None],
                                     w_vec=rng.dirichlet(np.ones(k)), prior_offset=rng.uniform(5.0, 15.0))


@pytest.mark.parametrize("w,r", SIDES, ids=SIDE_IDS)
def test_kaldi_ivector_extractor(tmp_path, w, r):
    rng = np.random.default_rng(2)
    model = _kaldi_ie(w, rng)
    path, other = str(tmp_path / "final.ie"), str(tmp_path / "final2.ie")
    w.write_kaldi_ivector_extractor(model, path)
    r.write_kaldi_ivector_extractor(r.KaldiIvectorExtractor(model.m, model.sigma_inv, model.w_vec,
                                                            model.prior_offset), other)
    assert open(path, "rb").read() == open(other, "rb").read()
    got, mine = r.read_kaldi_ivector_extractor(path), w.read_kaldi_ivector_extractor(path)
    for f in ("m", "sigma_inv", "w_vec"):
        _eq(getattr(got, f), getattr(mine, f))
        _eq(getattr(got, f), getattr(model, f))
    assert got.prior_offset == mine.prior_offset == model.prior_offset and got.ivector_dim == 3
    n = rng.uniform(0.5, 30.0, size=(5, 4))
    f = rng.normal(size=(5, 4, 6)) * 3
    _eq(got.extract(w.BaumWelchStats(n, f)), mine.extract(r.BaumWelchStats(n, f)))


# --------------------------------------------------------------------------
# 10. ScoreSets
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sv_task():
    """tests/test_backend.py's pipeline task: 80 x 12 training vectors of
    a PLDA generative model (D=24), 40 enroll, 40 target and 80 nontarget
    tests, every enroll against every test, a 200-vector cohort."""
    rng = np.random.default_rng(42)
    train_x, train_ids = synth_data(rng, n_spk=80, n_utt=12, dim=24)
    within = np.linspace(0.2, 2.0, 24)
    em = rng.normal(size=(40, 24)) * 1.5
    enroll = {f"e{i}": em[i] + rng.normal(size=24) * np.sqrt(within) for i in range(40)}
    test = {f"t{i}": em[i] + rng.normal(size=24) * np.sqrt(within) for i in range(40)}
    test.update({f"n{i}": rng.normal(size=24) * 1.5 + rng.normal(size=24) * np.sqrt(within) for i in range(80)})
    rows = [(f"e{i}", k, int(k == f"t{i}")) for i in range(40) for k in test]
    cohort = rng.normal(size=(200, 24)) * 1.5
    adapt = rng.normal(size=(100, 24)) + 1.0
    return train_x, train_ids, enroll, test, rows, cohort, adapt


def _within_one_target(a, b, n_target):
    assert a["num_trials"] == b["num_trials"]
    for k in ("eer", "min_dcf"):
        assert abs(a[k] - b[k]) <= 1.0 / n_target, (k, a[k], b[k])


def _restore_first_mean(pj, train_x):
    """JAX's ScoreSets keeps one mean for both mean steps of
    "mean-lda-submean-...": its transform subtracts the second (LDA-space)
    mean from the input and fails. Its fit is right, so the reference here
    is JAX's fitted pieces with the first mean restored from JAX's
    global_mean of the training vectors."""
    with pytest.raises(ValueError, match="could not be broadcast"):
        pj.transform(train_x[:2])
    first = J.global_mean(train_x.astype(np.float64))

    def transform(v):
        x, means = v.astype(np.float64), [first, pj._mean]
        for step in pj.config.process.split("-"):
            if step in ("mean", "submean"):
                x = x - means.pop(0)
            elif step == "lda":
                x = x @ pj._lda
            elif step == "whiten":
                x = pj._whiten.transform(x)
            elif step == "norm":
                x = J.length_norm(x)
        return x

    pj.transform = transform


@pytest.mark.parametrize("process,classifier,norm", [
    ("submean-norm", "cosine", None),
    ("submean-norm", "cosine", "snorm"),
    ("submean-norm", "cosine", "asnorm"),
    ("", "cosine", None),
    ("mean-lda-submean-whiten-norm", "cosine", "asnorm"),
    ("submean-lda-norm", "plda", None),
    ("submean-lda-norm", "plda", "asnorm"),
    ("mean-lda-submean-whiten-norm", "plda", "snorm"),
    ("submean-pcawhiten-norm", "plda", None),
    ("submean-norm", "aplda", None),
])
def test_score_sets_pairwise(sv_task, process, classifier, norm):
    train_x, train_ids, enroll, test, rows, cohort, adapt = sv_task
    kw = dict(process=process, classifier=classifier, score_norm=norm, top_n=100, lda_dim=16)
    fit_kw = {"adapt_vectors": adapt} if classifier == "aplda" else {}
    pp = P.ScoreSets(P.ScoreConfig(**kw), device="cpu").fit(train_x, train_ids, **fit_kw)
    pj = J.ScoreSets(J.ScoreConfig(**kw)).fit(train_x, train_ids, **fit_kw)
    if process.startswith("mean-lda-submean"):
        _restore_first_mean(pj, train_x)
    e = np.stack([enroll[k] for k in sorted(enroll)])
    t = np.stack([test[k] for k in sorted(test)])
    _eq(pp.transform(t), pj.transform(t))
    sp, sj = pp.score_matrix(e, t), pj.score_matrix(e, t)
    if classifier == "cosine":
        assert sp.dtype == np.float32 and pp.device_fetches == 1
        np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-6)
    else:
        _eq(sp, sj)
        _plda_eq(pp._plda, pj._plda)
        assert pp.device_fetches == 0
    trials_p = P.Trials(*zip(*rows))
    trials_j = J.Trials(*zip(*rows))
    out_p = pp.run(enroll, test, trials_p, cohort=cohort)
    out_j = pj.run(enroll, test, trials_j, cohort=cohort)
    if classifier == "cosine":
        assert pp.device_fetches == 1 + (3 if norm else 1)  # raw, enroll-cohort, test-cohort
        _within_one_target(out_p, out_j, 40)
    else:
        assert out_p == out_j
    assert out_p["eer"] < 0.2


@pytest.mark.parametrize("clf", ["lr", "svm", "gmm"])
def test_score_sets_class_classifiers(clf):
    """The LID path: one model per class trained on the enroll vectors
    (tests/test_backend.py TestScoreSetsClassClassifiers)."""
    if clf != "gmm":
        pytest.importorskip("sklearn")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 16)) * 3.0
    enroll, labels, test, t_labels = {}, {}, {}, {}
    for c in range(4):
        for i in range(30):
            enroll[f"c{c}_e{i}"] = (centers[c] + rng.normal(size=16)).astype(np.float32)
            labels[f"c{c}_e{i}"] = f"lang{c}"
        for i in range(6):
            test[f"c{c}_t{i}"] = (centers[c] + rng.normal(size=16)).astype(np.float32)
            t_labels[f"c{c}_t{i}"] = f"lang{c}"
    rows = [(f"lang{c}", tk, int(tc == f"lang{c}")) for tk, tc in t_labels.items() for c in range(4)]
    x = np.stack(list(enroll.values()))
    ids = np.asarray([labels[k] for k in enroll])
    outs, mats = [], []
    for m, kw in ((P, {"device": "cpu"}), (J, {})):
        pipe = m.ScoreSets(m.ScoreConfig(process="norm", classifier=clf, gmm_components=4), **kw).fit(x, ids)
        mats.append(pipe.class_score_matrix(enroll, np.stack([test[k] for k in sorted(test)]), labels))
        outs.append(pipe.run(enroll, test, m.Trials(*zip(*rows)), enroll_labels=labels))
        with pytest.raises(ValueError):
            m.ScoreSets(m.ScoreConfig(process="norm", classifier=clf, score_norm="snorm"), **kw).fit(x, ids).run(
                enroll, test, m.Trials(*zip(*rows)), cohort=np.zeros((5, 16)), enroll_labels=labels)
    _eq(mats[0][0], mats[1][0])
    assert mats[0][1] == mats[1][1]
    assert outs[0] == outs[1] and outs[0]["eer"] < 0.1


def test_score_sets_errors():
    pipe = P.ScoreSets(P.ScoreConfig(process="submean-bogus"), device="cpu")
    with pytest.raises(ValueError, match="unknown process step"):
        pipe.fit(np.ones((4, 3)), np.arange(4))
    with pytest.raises(ValueError, match="aplda needs adapt_vectors"):
        P.ScoreSets(P.ScoreConfig(classifier="aplda"), device="cpu").fit(np.random.default_rng(0).normal(size=(8, 3)),
                                                                         np.arange(8) % 2)


# --------------------------------------------------------------------------
# 11. the package: exports, imports, no fallback
# --------------------------------------------------------------------------

def test_backend_exports_match_jax():
    assert {n for n in dir(P) if not n.startswith("_")} == {n for n in dir(J) if not n.startswith("_")}


def test_backend_imports_neither_jax_nor_sklearn():
    import subprocess

    code = ("import sys, asv_subtools_tpu_torch.backend, asv_subtools_tpu_torch.io; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'asv_subtools_tpu', 'sklearn', 'matplotlib')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_functions_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, ec, tc = _cohort_scores(4, 5, 20, seed=4)
    plda = _rand_plda(P, np.random.default_rng(0), d=20)
    for call in (lambda: P.ScoreSets(), lambda: P.asnorm_device(raw, ec, tc),
                 lambda: P_plda.llr_matrix_device(plda, ec, tc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
