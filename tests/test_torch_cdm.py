"""Parity of the PyTorch port's CDM (``afford_motion_torch.models.cdm`` and
``models/perceiver.py``) with the JAX package's, at a small width on the CPU:
the Perceiver (2 heads, latent 64, point tokens 32, 1 latent self-attention
layer) and the MLP (point-scene MLPs 48 and 32 wide), 512-point clouds,
batch 2, no scene model.

Both sides get the same weights (flax init, carried across by the port's
name table ``cdm_state_dict_from_jax``, loaded with ``strict=True``) and the
same inputs, made from a numpy seed. Tolerances: float32 1e-5 (abs and rel;
the readings were 2.5e-6 of 7.1 and 1.4e-6 of 1.4); bfloat16 5e-2 of the
output's largest entry (readings: 0.6% Perceiver, 1.8% MLP; the two
frameworks round to bf16 at different points). One train step at dropout 0
goes through ``tests/test_torch_train.py``'s ``_compare_train_steps`` and
its tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models.cdm import CDM as JaxCDM
from afford_motion_tpu.models.perceiver import CrossAttentionLayer as JaxCross
from afford_motion_tpu.models.perceiver import SelfAttentionBlock as JaxSelfBlock
from afford_motion_tpu.utils.torch_convert import convert_cdm_checkpoint, export_cdm_checkpoint
from afford_motion_torch.models import perceiver
from afford_motion_torch.models.base import create_model
from afford_motion_torch.models.cdm import CDM, build_cdm
from afford_motion_torch.models.layers import set_dropout_generator
from afford_motion_torch.utils.config import load_config
from afford_motion_torch.utils.convert import cdm_jax_tree_from_state_dict, cdm_state_dict_from_jax

B, N, C, TEXT, TIME = 2, 512, 6, 64, 32
PERCEIVER = dict(point_pos_emb=True, encoder_q_input_channels=64, encoder_kv_input_channels=32,
                 encoder_num_heads=2, encoder_self_attn_num_layers=1,
                 decoder_q_input_channels=32, decoder_kv_input_channels=64,
                 decoder_num_heads=2, encoder_dropout=0.1, decoder_dropout=0.1)
MLP = dict(point_mlp_dims=(48, 32), point_mlp_widening_factor=2, point_mlp_bias=True)
ARCHS = {"Perceiver": (PERCEIVER, dict(self_attn_layers=1)),
         "MLP": (MLP, dict(mlp_layers=2))}
TOL_F32 = 1e-5
TOL_BF16 = 5e-2  # of the output's largest entry


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, N, C)).astype(np.float32)
    t = rng.integers(0, 500, size=(b,)).astype(np.int32)
    cond = {"c_pc_xyz": rng.normal(size=(b, N, 3)).astype(np.float32),
            "text_emb": rng.normal(size=(b, 1, TEXT)).astype(np.float32)}
    return x, t, cond


def _jax_model(arch, dtype="float32", **over):
    ac = dict(ARCHS[arch][0], **over)
    return JaxCDM(contact_dim=C, time_emb_dim=TIME, text_feat_dim=TEXT, point_feat_dim=0,
                  use_scene_model=False, arch=arch, arch_cfg=tuple(ac.items()),
                  dtype=jnp.dtype(dtype))


def _torch_model(arch, variables, dtype="float32", **over):
    tm = CDM(C, TIME, TEXT, arch=arch, arch_cfg=dict(ARCHS[arch][0], **over),
             dtype=getattr(torch, dtype))
    tm.load_state_dict(cdm_state_dict_from_jax(variables, arch=arch, **ARCHS[arch][1]),
                       strict=True)
    return tm


@pytest.fixture(scope="module")
def variables():
    """Per arch: flax variables of the JAX CDM, from its seeded init."""
    x, t, cond = _inputs()
    out = {}
    for arch in ARCHS:
        init = jax.jit(_jax_model(arch).init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                              jnp.asarray(t), {k: jnp.asarray(v)
                                                               for k, v in cond.items()})
        out[arch] = jax.device_get(init)
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_name_table_roundtrip_and_export(variables, arch):
    """JAX -> torch -> JAX is the identity bit for bit, the state_dict is
    the one the JAX package's ``export_cdm_checkpoint`` writes (same keys,
    same arrays), and its ``convert_cdm_checkpoint`` reads it back."""
    var = {"params": variables[arch]["params"]}
    sd = cdm_state_dict_from_jax(var, arch=arch, **ARCHS[arch][1])
    back = cdm_jax_tree_from_state_dict(sd, arch=arch, **ARCHS[arch][1])
    a, b = dict(_flat(back)), dict(_flat(var))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    exported = export_cdm_checkpoint(var, arch=arch, **ARCHS[arch][1])
    assert set(exported) == set(sd)
    for k, v in exported.items():
        assert np.array_equal(np.asarray(v), sd[k].numpy()), k
    conv = convert_cdm_checkpoint({k: v.numpy() for k, v in sd.items()}, arch=arch,
                                  **ARCHS[arch][1])
    c = dict(_flat({"params": conv["params"]}))
    assert sorted(c) == sorted(b) and all(np.array_equal(c[k], b[k]) for k in c)
    # the port's modules carry exactly these names
    assert set(CDM(C, TIME, TEXT, arch=arch, arch_cfg=ARCHS[arch][0]).state_dict()) == set(sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cdm_forward_matches_jax(variables, arch, dtype):
    """``CDM.apply`` in eval mode against the port's forward, the f32 head's
    output of shape (B, N, C)."""
    x, t, cond = _inputs(2)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    jm = _jax_model(arch, dtype)
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(t), jc))(
        variables[arch]))
    tm = _torch_model(arch, variables[arch], dtype).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(v) for k, v in cond.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, N, C)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert np.abs(got.numpy() - want).max() <= TOL_BF16 * np.abs(want).max()


@pytest.mark.parametrize("layer", ["cross", "self"])
def test_perceiver_layers_match_jax(layer):
    """A cross-attention layer (3 queries of 64 over 40 keys of 32, with a
    padding mask) and a 2-layer self-attention block, f32, 1e-5."""
    rng = np.random.default_rng(5)
    xq = rng.normal(size=(2, 3, 64)).astype(np.float32)
    xkv = rng.normal(size=(2, 40, 32)).astype(np.float32)
    pad = np.zeros((2, 40), bool)
    pad[1, 30:] = True
    if layer == "cross":
        jl = JaxCross(num_heads=4, num_q_input_channels=64, num_kv_input_channels=32,
                      widening_factor=2)
        args = (jnp.asarray(xq), jnp.asarray(xkv), jnp.asarray(pad))
        tl = perceiver.CrossAttentionLayer(4, 64, 32, widening_factor=2)
        targs = (torch.from_numpy(xq), torch.from_numpy(xkv), torch.from_numpy(pad))
    else:
        jl = JaxSelfBlock(num_layers=2, num_heads=4, num_channels=64)
        args = (jnp.asarray(xq),)
        tl = perceiver.SelfAttentionBlock(2, 4, 64)
        targs = (torch.from_numpy(xq),)
    var = jax.device_get(jax.jit(jl.init)(jax.random.PRNGKey(3), *args))
    want = np.asarray(jax.jit(jl.apply)(var, *args))
    # the name table's layer entries, mounted at the layer's own root
    from afford_motion_torch.utils.convert import _perceiver_layer, _state_dict_from_jax
    if layer == "cross":
        table = list(_perceiver_layer("l", (), cross=True))
    else:
        table = [e for i in range(2) for e in _perceiver_layer(
            f"l.{i}", (f"SelfAttentionLayer_{i}",), cross=False)]
    sd = _state_dict_from_jax(var, table)
    tl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tl.eval()(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


def test_train_step_matches_jax(variables):
    """Three optimizer steps of the Perceiver CDM at dropout 0 (dropout is
    drawn from different generators on the two sides), with injected t and
    noise, through ``_compare_train_steps``: the loss, every gradient, the
    parameters after AdamW."""
    from test_torch_train import _compare_train_steps

    x, _, cond = _inputs(7, b=4)
    jm = _jax_model("Perceiver", encoder_dropout=0.0, decoder_dropout=0.0)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    var = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x),
                                          jnp.zeros((4,), jnp.int32), jc))
    var = {"params": var["params"]}
    tm = _torch_model("Perceiver", var, encoder_dropout=0.0, decoder_dropout=0.0)
    rng = np.random.default_rng(8)
    steps = {"jm": jm,
             "ts": [np.array([10, 700, 0, 999]), np.array([5, 250, 640, 31]),
                    np.array([900, 1, 77, 420])],
             "noises": [rng.standard_normal(x.shape).astype(np.float32) for _ in range(3)]}
    _compare_train_steps(steps, var, jc, {k: torch.from_numpy(v) for k, v in cond.items()}, x,
                         tm, 0.0, 0,
                         to_tree=lambda t: cdm_jax_tree_from_state_dict(t, arch="Perceiver",
                                                                        self_attn_layers=1))


def test_dropout_sits_on_the_attention_weights(variables):
    """With ``encoder_dropout``/``decoder_dropout`` 0.1 the train-mode output
    depends on the generator and repeats with it; eval mode is
    deterministic; one Dropout per attention plus one per residual branch."""
    x, t, cond = _inputs(3)
    tm = _torch_model("Perceiver", variables["Perceiver"])
    args = (torch.from_numpy(x), torch.from_numpy(t),
            {k: torch.from_numpy(v) for k, v in cond.items()})
    outs = []
    for seed in (1, 1, 2):
        set_dropout_generator(tm.train(), torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(tm(*args))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        assert torch.equal(tm.eval()(*args), tm(*args))
    drops = [m for m in tm.modules() if isinstance(m, perceiver.Dropout)]
    assert sorted(m.p for m in drops) == [0.0] * 6 + [0.1] * 3


def _cfg(*extra, task="text_to_motion_contact_gen"):
    cfg = load_config("configs", [f"task={task}", "model=cdm", *extra])
    cfg.model.input_feats = 6
    return cfg.model


def test_create_model_builds_the_published_cdm_and_refuses_the_rest(tmp_path):
    """``create_model`` builds the CDM-Perceiver of ``scripts/t2m_contact``
    at full width (bf16, 512-wide encoder of 8 heads, 2 latent layers,
    256-wide decoder) and the CDM-MLP; the shipped default (MLP with the
    frozen scene model), the point-transformer backbones and the OpenScene
    features build too. Refused: a scene model on the HumanML3D task (whose
    items carry no ``c_pc_feat``), and what is still unported, a local text
    encoder's weights; ``prepare`` takes the MotionX sets and refuses a set
    without contacts."""
    cpu = torch.device("cpu")
    m = create_model(_cfg("model.arch=Perceiver", "model.scene_model.use_scene_model=False"),
                     cpu)
    cm = m.contact_model
    assert isinstance(m, CDM) and m.dtype == torch.bfloat16 and not m.training
    assert (cm.encoder_adapter.in_features, cm.encoder_adapter.out_features) == (9, 256)
    assert cm.language_adapter.out_features == 512 and len(cm.encoder_self_attn) == 2
    assert cm.encoder_cross_attn[0].module.attention.num_heads == 8
    assert m.contact_layer.in_features == 256 and m.contact_layer.compute_dtype == torch.float32
    mlp = create_model(_cfg("model.scene_model.use_scene_model=False"), cpu)
    assert [b.mlp_post[3].out_features for b in mlp.contact_model.point_mlp] == [512, 512]
    assert mlp.contact_layer.in_features == 512
    shipped = create_model(_cfg(task="contact_gen"), cpu)
    assert shipped.arch == "MLP" and shipped.needs_seg_hierarchy and not shipped.scene_model.training
    assert shipped.contact_model.point_mlp[0].mlp_pre[1].in_features == 6 + 32 + 512 + 128
    for task, extra in (
            ("text_to_motion_contact_gen", ["model.arch=PointTrans",
                                            "model.scene_model.use_scene_model=False"]),
            ("text_to_motion_contact_gen", ["model.arch=PointTransV2",
                                            "model.scene_model.use_scene_model=False"]),
            ("contact_gen", ["model.arch=Perceiver"]),
            ("contact_gen", ["model.arch=Perceiver", "task.dataset.use_openscene=true",
                             "model.scene_model.point_feat_dim=1"])):
        assert isinstance(build_cdm(_cfg(*extra, task=task)), CDM)
    with pytest.raises(ValueError, match="c_pc_feat"):
        build_cdm(_cfg("model.arch=Perceiver"))
    from afford_motion_torch import prepare
    from afford_motion_torch.models.text import create_text_encoder
    with pytest.raises(FileNotFoundError, match="config.json"):
        create_text_encoder("ViT-B/32", weights_dir=str(tmp_path))
    # prepare takes the MotionX sets: a tree without HUMANISE contacts is
    # refused for that, not for the set (tests/test_torch_motionx_store.py)
    with pytest.raises(FileNotFoundError, match="no contacts under"):
        prepare.main(["sort", "--dataset", "HUMANISE", "--out_dir", str(tmp_path)])
    # the published ts2m configuration resolves use_openscene to false
    assert isinstance(build_cdm(_cfg("model.arch=Perceiver",
                                      "model.scene_model.use_scene_model=False",
                                      task="contact_gen")), CDM)
