"""The port's HumanML3D metric stack (``afford_motion_torch/eval/{t2m_models,
evaluator_wrapper, eval_humanml, metrics, word_vectorizer}.py`` and
``afford_motion_torch/h3d_eval``) against the JAX package's, on the CPU.

Inputs come from numpy seeds; one set of evaluator weights serves both
packages (``utils/convert.py t2m_state_dicts_from_jax``). Tolerances:
- the encoders and the wrapper: rtol 2e-4, atol 1e-5 (the bar of the JAX
  package's own ``tests/test_eval_stack.py`` against torch), f32;
- tokens, word vectors and the metric formulas on the same inputs: bit for
  bit; Diversity and MultiModality with ``RandomState(s)`` on the port's
  side and ``np.random.seed(s)`` on the JAX side;
- the protocols end to end (in process, and offline in ``wo_mm`` and
  ``mm_short``): R-precision exact (a rank flips only on a near-tie, and
  these embeddings have none), Matching Score, FID, Diversity and
  MultiModality within 1e-4 relative (the embeddings differ by rounding:
  the JAX side runs its GRU as a masked scan, the port as torch's GRU).
"""
import json
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.eval import eval_humanml as jeh
from afford_motion_tpu.eval import evaluator_wrapper as jew
from afford_motion_tpu.eval import metrics as jmet
from afford_motion_tpu.eval import motion_repr as jrepr
from afford_motion_tpu.eval import t2m_models as jt2m
from afford_motion_tpu.eval import word_vectorizer as jwv
from afford_motion_torch.data import synthetic as syn
from afford_motion_torch.eval import eval_humanml as teh
from afford_motion_torch.eval import evaluate as teval
from afford_motion_torch.eval import evaluator_wrapper as tew
from afford_motion_torch.eval import metrics as tmet
from afford_motion_torch.eval import motion_repr as trepr
from afford_motion_torch.eval import t2m_models as tt2m
from afford_motion_torch.eval import word_vectorizer as twv
from afford_motion_torch.h3d_eval import eval_h3d_offline as toff
from afford_motion_torch.utils.config import DictConfig
from afford_motion_torch.utils.convert import (
    t2m_jax_params_from_state_dicts,
    t2m_state_dicts_from_jax,
)

RTOL, ATOL = 2e-4, 1e-5
METRIC_RTOL = 1e-4
SMALL = dict(dim_move=32, hid_text=24, hid_motion=32, coemb=16)


def _params(dim_pose, strip, seed, dim_move=32, hid_text=24, hid_motion=32, coemb=16):
    """Seeded numpy weights in the checkpoint's names at the given widths
    (the learned ``hidden`` included, so a row of length 0 shows it)."""
    d_in = dim_pose - 4 if strip else dim_pose
    mods = {"movement_encoder": tt2m.MovementConvEncoder(d_in, dim_move, dim_move),
            "text_encoder": tt2m.TextEncoderBiGRUCo(300, 15, hid_text, coemb),
            "motion_encoder": tt2m.MotionEncoderBiGRUCo(dim_move, hid_motion, coemb)}
    rng = np.random.default_rng(seed)
    out = t2m_jax_params_from_state_dicts({k: m.state_dict() for k, m in mods.items()})
    return {net: {k: (rng.normal(size=v.shape) * (0.3 if k == "hidden" else 0.15)).astype(
        np.float32) for k, v in p.items()} for net, p in out.items()}


def _write_ckpt(path, params):
    """``params`` as a ``finest.tar`` of the real layout. Seeded weights
    rather than ``make_synthetic_t2m_ckpt``'s, whose shrunk GRUs give nearly
    equal embeddings and so tied distances, where R-precision would rest on
    rounding."""
    torch.save({net: {k: torch.tensor(v) for k, v in p.items()} for net, p in params.items()},
               path)


def _modules(params):
    return tt2m.build_t2m_modules(t2m_state_dicts_from_jax(params))


# ----------------------------------------------------------------- encoders
@pytest.mark.parametrize("net", ["movement_encoder", "text_encoder", "motion_encoder"])
def test_encoders_match_jax(net):
    params = _params(62, False, seed=3)
    mod = _modules(params)[net]
    rng = np.random.default_rng(4)
    with torch.no_grad():
        if net == "movement_encoder":
            x = rng.normal(size=(3, 32, 62)).astype(np.float32)
            got = mod(torch.from_numpy(x)).numpy()
            want = jt2m.movement_encoder(params[net], jnp.asarray(x))
        elif net == "text_encoder":
            w = rng.normal(size=(5, 22, 300)).astype(np.float32)
            p = rng.normal(size=(5, 22, 15)).astype(np.float32)
            lens = np.array([2, 22, 9, 9, 15])      # unsorted, tied
            got = mod(torch.from_numpy(w), torch.from_numpy(p), lens).numpy()
            want = jt2m.text_encoder(params[net], jnp.asarray(w), jnp.asarray(p),
                                     jnp.asarray(lens))
        else:
            x = rng.normal(size=(6, 12, 32)).astype(np.float32)
            lens = np.array([12, 0, 7, 1, 0, 12])   # rows of length 0 keep `hidden`
            got = mod(torch.from_numpy(x), lens).numpy()
            want = jt2m.motion_encoder(params[net], jnp.asarray(x), jnp.asarray(lens))
            zero = mod.output_net(mod.hidden[:, 0].reshape(1, -1)).detach().numpy()[0]
            np.testing.assert_allclose(got[1], zero, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_encoders_match_jax_at_the_real_layout():
    """``synthetic_t2m_params`` (the same draws in both packages) at the
    checkpoint's sizes through both wrappers, 6 rows, one under 4 frames."""
    params = tt2m.synthetic_t2m_params(263, strip_last4=True, seed=1)
    jparams = jt2m.synthetic_t2m_params(263, strip_last4=True, seed=1)
    for net in params:
        assert params[net].keys() == jparams[net].keys()
        assert all(np.array_equal(params[net][k], jparams[net][k]) for k in params[net])
    rng = np.random.default_rng(5)
    n = 6
    w = rng.normal(size=(n, 22, 300)).astype(np.float32)
    p = np.eye(15, dtype=np.float32)[rng.integers(0, 15, size=(n, 22))]
    cap = np.array([22, 5, 12, 7, 22, 3])
    mot = rng.normal(size=(n, 196, 263)).astype(np.float32)
    m_lens = np.array([196, 3, 40, 120, 77, 196])
    port = tew.EvaluatorWrapper("", "mdm", params=params, device="cpu")
    ref = jew.EvaluatorWrapper("", "mdm", params=jparams)
    for a, b in zip(port.get_co_embeddings(w, p, cap, mot, m_lens),
                    ref.get_co_embeddings(w, p, cap, mot, m_lens)):
        assert a.shape == (n, 512)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unsort", [False, True])
def test_wrapper_matches_jax(unsort):
    """Both outputs in the length order (ties in ``np.argsort(...)[::-1]``'s)
    or in the input order; numpy and tensor inputs."""
    params = _params(66, False, seed=6)
    port = tew.EvaluatorWrapper("", "ours", params=params, device="cpu")
    ref = jew.EvaluatorWrapper("", "ours", params=params)
    rng = np.random.default_rng(7)
    n = 9
    w = rng.normal(size=(n, 22, 300)).astype(np.float32)
    p = rng.normal(size=(n, 22, 15)).astype(np.float32)
    cap = rng.integers(2, 23, size=n)
    mot = rng.normal(size=(n, 40, 66)).astype(np.float32)
    m_lens = np.array([40, 24, 40, 2, 33, 24, 40, 8, 3])
    want = ref.get_co_embeddings(w, p, cap, mot, m_lens, unsort=unsort)
    for motions in (mot, torch.from_numpy(mot)):
        got = port.get_co_embeddings(w, p, cap, motions, m_lens, unsort=unsort)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    got = port.get_motion_embeddings(mot, m_lens, unsort=unsort)
    np.testing.assert_allclose(got, np.asarray(ref.get_motion_embeddings(mot, m_lens,
                                                                         unsort=unsort)),
                               rtol=RTOL, atol=ATOL)
    dev = port.get_motion_embeddings(torch.from_numpy(mot), m_lens, unsort=unsort,
                                     device_out=True)
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), got)


def test_wrapper_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device=cpu"):
        tew.EvaluatorWrapper("", "mdm", params=_params(263, True, seed=0))


def test_weights_convert_and_load_strict(tmp_path):
    """A ``finest.tar`` in the real layout loads into the modules with
    ``strict=True``; the conversion goes both ways and refuses wrong names
    and ranks."""
    syn.make_synthetic_t2m_ckpt(str(tmp_path / "finest.tar"), **SMALL)
    params = tt2m.load_t2m_checkpoint(str(tmp_path / "finest.tar"))
    jparams = jt2m.load_t2m_checkpoint(str(tmp_path / "finest.tar"))
    mods = _modules(params)
    back = t2m_jax_params_from_state_dicts({k: m.state_dict() for k, m in mods.items()})
    for net in params:
        assert all(np.array_equal(back[net][k], jparams[net][k]) for k in jparams[net])
    bad = {k: dict(v) for k, v in params.items()}
    del bad["text_encoder"]["hidden"]
    with pytest.raises(KeyError, match="hidden"):
        t2m_state_dicts_from_jax(bad)
    bad = {k: dict(v) for k, v in params.items()}
    bad["motion_encoder"]["gru.bias_ih_l0"] = bad["motion_encoder"]["gru.bias_ih_l0"][None]
    with pytest.raises(ValueError, match="rank 1"):
        t2m_state_dicts_from_jax(bad)


# -------------------------------------------------- tokens, vectors, metrics
def test_tokenize_and_vectorizers_bitwise(tmp_path):
    syn.make_synthetic_glove(str(tmp_path / "glove"), seed=2)
    real = (twv.create_word_vectorizer(str(tmp_path / "glove")),
            jwv.create_word_vectorizer(str(tmp_path / "glove")))
    assert type(real[0]) is twv.WordVectorizer and type(real[1]) is jwv.WordVectorizer
    hashed = (twv.create_word_vectorizer(str(tmp_path / "none")),
              jwv.create_word_vectorizer(str(tmp_path / "none")))
    assert type(hashed[0]) is twv.HashWordVectorizer
    rng = np.random.default_rng(0)
    captions = [[], "a/DET person/NOUN walk/VERB", syn.synthetic_caption(rng, 20)[1],
                syn.synthetic_caption(rng, 27)[1] + ["zebra/NOUN", "chair/VERB"]]
    for port, ref in (real, hashed):
        for tokens in captions:
            a, b = teh.tokenize(tokens, port), jeh.tokenize(tokens, ref)
            assert a[2] == b[2] and a[0].shape == (22, 300) and a[1].shape == (22, 15)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert teh.tokenize(captions[3], real[0])[2] == 22


def test_metrics_bitwise():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(32, 16)), rng.normal(size=(32, 16))
    c = rng.normal(size=(300, 16)) + 0.3
    for name in ("euclidean_distance_matrix", "calculate_matching_score"):
        assert np.array_equal(getattr(tmet, name)(a, b), getattr(jmet, name)(a, b))
    assert np.array_equal(tmet.calculate_R_precision(a, b, 3, sum_all=True),
                          jmet.calculate_R_precision(a, b, 3, sum_all=True))
    srt = np.argsort(tmet.euclidean_distance_matrix(a, b), axis=1)
    assert np.array_equal(tmet.calculate_top_k(srt, 3), jmet.calculate_top_k(srt, 3))
    stats = tmet.calculate_activation_statistics(c)
    gt = tmet.calculate_activation_statistics(a)
    assert all(np.array_equal(x, y) for x, y in zip(stats, jmet.calculate_activation_statistics(c)))
    assert tmet.calculate_frechet_distance(*gt, *stats) == \
        jmet.calculate_frechet_distance(*gt, *stats) > 0
    for s in (0, 11):
        np.random.seed(s)
        want = jmet.calculate_diversity(c, 200)
        assert tmet.calculate_diversity(c, 200, np.random.RandomState(s)) == want
        acts = rng.normal(size=(20, 30, 16))
        np.random.seed(s)
        want = jmet.calculate_multimodality(acts, 10)
        assert tmet.calculate_multimodality(acts, 10, np.random.RandomState(s)) == want
    with pytest.raises(ValueError):
        tmet.calculate_diversity(a, 32, np.random.RandomState(0))


def test_motion_repr_bitwise():
    data = np.random.default_rng(2).normal(size=(2, 30, 263)).astype(np.float32)
    assert np.array_equal(trepr.recover_from_ric(data), jrepr.recover_from_ric(data))
    q = np.random.default_rng(3).normal(size=(5, 4))
    assert np.array_equal(trepr.qrot(trepr.qinv(q), data[0, :5, :3]),
                          jrepr.qrot(jrepr.qinv(q), data[0, :5, :3]))


def test_multimodality_of_ragged_groups():
    """k-sample groups of different (k, frames) give a result; groups of one
    shape give the JAX package's."""
    params = _params(263, True, seed=8)
    port = tew.EvaluatorWrapper("", "mdm", params=params, device="cpu")
    rng = np.random.default_rng(9)

    def group(k, frames, length):
        return {"k_samples": rng.normal(size=(k, frames, 263)).astype(np.float32),
                "x_mask": np.arange(frames) >= length}

    ragged = [group(12, 40, 36), group(12, 40, 17), group(14, 32, 32), group(12, 196, 3),
              group(12, 40, 40)]
    mm = teh.evaluate_multimodality_metric(port, ragged, 10, np.random.RandomState(0),
                                           extract_groups=3)
    assert np.isfinite(mm) and mm > 0
    uniform = [group(12, 40, n) for n in (40, 9, 30, 22, 3)]
    np.random.seed(1)
    want = jeh.evaluate_multimodality_metric(jew.EvaluatorWrapper("", "mdm", params=params),
                                             uniform, 10, extract_groups=3)
    got = teh.evaluate_multimodality_metric(port, uniform, 10, np.random.RandomState(1),
                                            extract_groups=3)
    assert abs(got - want) <= METRIC_RTOL * abs(want)


# ------------------------------------------------------------- the protocols
def _assert_metrics_agree(got, want):
    assert list(got) == list(want)
    for metric in want:
        assert list(got[metric]) == list(want[metric]), metric
        for model in want[metric]:
            a = np.asarray(got[metric][model], dtype=np.float64)
            b = np.asarray(want[metric][model], dtype=np.float64)
            assert a.shape == b.shape and np.isfinite(a).all(), (metric, model)
            if metric == "R_precision":
                assert np.array_equal(a, b), (metric, model, a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=METRIC_RTOL, atol=1e-6,
                                           err_msg=f"{metric} {model}")


@pytest.fixture(scope="module")
def in_process_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("h3d_in_process")
    syn.make_synthetic_h3d_contact_motion(str(root / "data"), n_items=44, seed=3)
    syn.make_synthetic_eval_meta(str(root / "eval"), test_ids=range(4, 44), seed=4)
    _write_ckpt(root / "finest.tar", _params(66, False, seed=10))
    rng = np.random.default_rng(5)
    samples, k_samples = [], []
    for i in range(20):
        cap, tokens = syn.synthetic_caption(rng, int(rng.integers(2, 25)))
        length = int(rng.integers(2, 197))
        case = {"x_mask": np.arange(196) >= length, "c_text": cap, "info_set": "HUMANISE",
                "info_index": i, "info_obj_mask": None, "info_scene_mesh": "",
                "info_scene_trans": np.eye(4, dtype=np.float32),
                "c_pc_xyz": rng.normal(size=(64, 3)).astype(np.float32)}
        if i % 3:
            case["info_tokens"] = tokens
        samples.append({"sample": rng.normal(size=(196, 66)).astype(np.float32), **case})
        k_samples.append({"k_samples": rng.normal(size=(12, 196, 66)).astype(np.float32),
                          **case})
    return root, samples, k_samples


def test_eval_humanml_in_process_matches_jax(in_process_tree):
    root, samples, k_samples = in_process_tree

    class _Dataset:
        data_dir = str(root / "data")

    class _Loader:
        dataset = _Dataset()

    kw = dict(eval_meta_dir=str(root / "eval"), ckpt_path=str(root / "finest.tar"),
              batch_size=4)
    random.seed(3)
    got = teh.eval_humanml(samples, k_samples, _Loader(), seed=7, device="cpu", **kw)
    random.seed(3)
    np.random.seed(7)
    want = jeh.eval_humanml(samples, k_samples, _Loader(), **kw)
    _assert_metrics_agree(got, want)
    assert 0 < len(got["FID"]) == 2


def _evaluator_cfg(root, **extra):
    return DictConfig({"evaluator": {
        "name": "Text2MotionInSceneEvaluator", "njoints": 22, "k_samples": 12,
        "num_k_samples": 20, "eval_nbatch": 1, "eval_metrics": ["apd", "Rprecison", "fid"],
        "save_results": False, "joints_to_smplx_model_weights": str(root / "none.pt"),
        "eval_meta_dir": str(root / "eval"), "t2m_ckpt_path": str(root / "finest.tar"),
        "eval_batch_size": 4, **extra}})


def test_scene_evaluator_humanml_metrics(in_process_tree, tmp_path):
    """``Rprecison``/``fid`` in ``eval_metrics``: the ``H3D+`` keys of the
    JAX evaluator, ``humanml_s`` in the timing; a missing checkpoint skips
    them with a warning."""
    root, samples, k_samples = in_process_tree

    class _Dataset:
        data_dir = str(root / "data")

        def denormalize(self, x, clip=False):
            return x

    class _Loader:
        dataset = _Dataset()

    ev = teval.create_evaluator(_evaluator_cfg(root), device="cpu")
    random.seed(0)
    ev.evaluate(samples, k_samples, str(tmp_path), _Loader())
    keys = sorted(k for k in ev.metrics if k.startswith("H3D+"))
    assert keys == sorted([f"H3D+{m}_{p}" for m in ("Matching Score", "R_precision", "FID",
                                                     "Diversity")
                           for p in ("ground truth", "vald")] + ["H3D+MultiModality_vald"])
    assert all(np.isfinite(ev.metrics[k]).all() for k in keys)
    assert len(ev.metrics["H3D+R_precision_vald"]) == 3
    assert set(ev.timing) == {"apd_s", "humanml_s"}
    ev.report(str(tmp_path))
    assert "H3D+FID_vald: " in (tmp_path / "metrics.txt").read_text()
    missing = teval.create_evaluator(_evaluator_cfg(root, t2m_ckpt_path=str(root / "no.tar")),
                                     device="cpu")
    missing.evaluate(samples, k_samples, str(tmp_path), _Loader())
    assert not any(k.startswith("H3D+") for k in missing.metrics) and "apd" in missing.metrics


@pytest.fixture(scope="module")
def offline_tree(tmp_path_factory):
    """A synthetic H3D tree of 40 test motions (no contact files), the eval
    meta, a small 'mdm' checkpoint, 24 generated motions and 6 k-sample
    groups written by the port's ``Text2MotionInSceneHumanML3DEvaluator``."""
    root = tmp_path_factory.mktemp("h3d_offline")
    syn.make_synthetic_h3d_protocol(str(root / "data"), n_train=2, n_test=40, dim=263,
                                    horizon_range=(24, 199), seed=6, contacts=False)
    syn.make_synthetic_eval_meta(str(root / "eval"), seed=7)
    _write_ckpt(root / "finest.tar", _params(263, True, seed=9))
    rng = np.random.default_rng(8)

    def case(i, length):
        cap, tokens = syn.synthetic_caption(rng, int(rng.integers(3, 24)))
        return {"x_mask": np.arange(196) >= length, "c_text": cap, "info_tokens": tokens,
                "info_index": f"{i:06d}", "info_caption_index": 0}

    samples = [{"sample": rng.normal(size=(196, 263)).astype(np.float32),
                **case(i, int(rng.integers(40, 197)))} for i in range(24)]
    k_samples = [{"k_samples": rng.normal(size=(12, 196, 263)).astype(np.float32),
                  **case(100 + i, int(rng.integers(40, 197)))} for i in range(6)]

    class _Dataset:
        def denormalize(self, x):
            return x * 1.5 + 0.2

    class _Loader:
        dataset = _Dataset()

    ev = teval.create_evaluator(DictConfig({"evaluator": {
        "name": "Text2MotionInSceneHumanML3DEvaluator", "save_results": True}}), device="cpu")
    ev.evaluate(samples, [], str(root / "gen"), _Loader())
    ev.evaluate([], k_samples, str(root / "mm"), _Loader())
    return root


@pytest.mark.parametrize("mode", ["wo_mm", "mm_short"])
def test_offline_protocol_matches_jax(offline_tree, mode):
    from h3d_eval import eval_h3d_offline as joff

    root = offline_tree
    kw = dict(data_dir=str(root / "data"), eval_meta_dir=str(root / "eval"),
              ckpt=str(root / "finest.tar"), eval_mode=mode, batch_size=8,
              mm_results_dir=str(root / "mm" / "humanml"))
    timing = {}
    got = toff.run_evaluation(str(root / "gen" / "humanml"), seed=5, device="cpu",
                              timing=timing, **kw)
    np.random.seed(5)
    want = joff.run_evaluation(str(root / "gen" / "humanml"), **kw)
    _assert_metrics_agree(got, want)
    assert (got["MultiModality"]["vald"][0] > 0) == (mode == "mm_short")
    stages = {"evaluator_s", "datasets_s", "pool_upload_s", "matching_s", "fid_s",
              "diversity_s"} | ({"multimodality_s"} if mode == "mm_short" else set())
    assert set(timing) == stages | {"pool_bytes"}
    # 40 + 24 items in pools of 8, each item 22 x 315 + 196 x 263 floats
    assert timing["pool_bytes"] == 64 * 4 * (22 * 315 + 196 * 263)


def test_offline_entry(offline_tree, tmp_path):
    """The entry on the CPU writes the JAX entry's JSON layout and the stage
    seconds, byte-identical metrics over two runs; it asks for the card by
    default."""
    import shutil

    root = offline_tree
    results = tmp_path / "humanml"
    shutil.copytree(root / "gen" / "humanml", results)
    args = ["--results_dir", str(results), "--data_dir", str(root / "data"),
            "--eval_meta_dir", str(root / "eval"), "--ckpt", str(root / "finest.tar"),
            "--batch_size", "8", "--eval_mode", "wo_mm"]
    out = toff.main(args + ["--device", "cpu"])
    first = open(out, "rb").read()
    assert out.endswith("eval_humanml_wo_mm.json") and toff.main(args + ["--device", "cpu"]) == out
    assert open(out, "rb").read() == first
    metrics = json.loads(first)
    assert list(metrics) == ["Matching Score", "R_precision", "FID", "Diversity",
                             "MultiModality"]
    assert len(metrics["R_precision"]["vald"][0]) == 3 and metrics["MultiModality"] == {
        "vald": [0.0]}
    timing = json.loads((results / "eval_humanml_wo_mm_timing.json").read_text())
    assert timing["pool_bytes"] > 0 and timing["matching_s"] >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            toff.main(args)


def test_offline_datasets_read_the_evaluator_files(offline_tree):
    """The generated files' order, normalization and lengths; the k-sample
    files' masks."""
    from afford_motion_torch.h3d_eval.eval_h3d_dataset_offline import (
        H3DEvalDataset,
        MMH3DEvalDataset,
    )

    root = offline_tree
    ms = np.load(root / "eval" / "meta" / "t2m_mean_std.npz")
    wv = twv.create_word_vectorizer(str(root / "eval" / "glove"))
    gen = H3DEvalDataset(str(root / "gen" / "humanml"), ms["mean"], ms["std"], wv, 5)
    assert len(gen) == 5
    raw = gen.items[0]
    item = gen[0]
    assert item["motion"].shape == (196, 263) and item["m_len"] == raw["m_len"]
    np.testing.assert_array_equal(item["motion"],
                                  (np.asarray(raw["motion"]) - ms["mean"]) / ms["std"])
    mm = MMH3DEvalDataset(str(root / "mm" / "humanml"), wv, 4)
    assert len(mm) == 4 and all(int((~mm[i]["x_mask"]).sum()) == mm.items[i]["m_len"]
                                for i in range(4))
    with open(sorted((root / "gen" / "humanml").glob("*.pkl"))[0], "rb") as f:
        assert list(pickle.load(f)) == ["name", "text", "tokens", "motion", "m_len"]
