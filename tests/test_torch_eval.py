"""The port's evaluation path (``fgdm_tpu_torch/cli/eval.py`` and the
modules it imports) held against the JAX package's on the CPU.

* The numpy metric modules (``utils/{seg,depth,edge,pose}_metrics.py``,
  ``bbox.py``) and ``fid.FeatureStats``/``frechet_distance``: bit for bit on
  seeded inputs.
* ``utils/inception``: JAX's ``init_inception_params(seed)`` carried
  across; ``inception_feature_fn`` on 64^2 (the resize grows) and 512^2
  (it shrinks, antialiased) inputs, max|d| <= 1e-5 * max|ref| + 1e-6; a
  torchvision-schema file (with ``fc.*``, ``AuxLogits.*``) loads, one
  without a key raises JAX's ``KeyError``.
* ``utils/clip_score``: a tiny ``CLIPVisionEncoder`` (hidden 64, 2 layers,
  2 heads, patch 14, image 56) and ``CLIPScorer`` (a one-layer text tower,
  embed 48), the port's seeded weights carried to flax through
  ``flax_paths``: features and scores within 1e-5.
* ``cli.eval.ingest_clip_towers`` on seeded HF- and OpenAI-schema files:
  each tensor lands in the slot JAX gives it (also at the ViT-L/14 widths,
  by shapes alone), the scores agree within 1e-5, and a file with a key
  removed, one with a key added, and OpenAI's ``visual.proj`` (which
  JAX's matcher has no slot for) give JAX's ``SystemExit``.
* ``cli.eval.main`` against JAX's ``main`` on an image directory with the
  same injected toy factories, every metric key (CLIP score, FID on CLIP
  and on Inception, mIoU, depth, normal, edge-F1, skeleton-F1): equal
  keys, each value within 1e-6 * max(1, |ref|); FID's ``sqrtm`` amplifies
  the features' float32 differences: CLIP-FID within 1e-4 relative.
  ``--inception_ckpt``'s backend gives pool3 features within 1e-5 of JAX's
  (its FID's two 2048^2 ``sqrtm``s would take most of a minute here).
* ``cli.eval._generate`` on ``tests/test_torch_cli.py``'s tiny config with
  JAX's x_T injected: within ``CHAIN_TOL``.
* The ``SystemExit`` texts of both CLIs for missing weights and inputs.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from fgdm_tpu.checkpoint import fuzzy_ingest as jfuzzy  # noqa: E402
from fgdm_tpu.cli import eval as jeval  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JText  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JTokenizer  # noqa: E402
from fgdm_tpu.utils import bbox as jbbox  # noqa: E402
from fgdm_tpu.utils import clip_score as jclip  # noqa: E402
from fgdm_tpu.utils import depth_metrics as jdepth  # noqa: E402
from fgdm_tpu.utils import edge_metrics as jedge  # noqa: E402
from fgdm_tpu.utils import fid as jfid  # noqa: E402
from fgdm_tpu.utils import inception as jinception  # noqa: E402
from fgdm_tpu.utils import pose_metrics as jpose  # noqa: E402
from fgdm_tpu.utils import seg_metrics as jseg  # noqa: E402
from fgdm_tpu_torch import full_f32  # noqa: E402
from fgdm_tpu_torch.checkpoint import fuzzy_ingest  # noqa: E402
from fgdm_tpu_torch.checkpoint.torch_ingest import (  # noqa: E402
    load_torch_state_dict)
from fgdm_tpu_torch.cli import eval as teval  # noqa: E402
from fgdm_tpu_torch.data.colorize import ade_cmap, colorize  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTokenizer  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.utils import bbox, depth_metrics, edge_metrics  # noqa: E402
from fgdm_tpu_torch.utils import fid, inception, pose_metrics  # noqa: E402
from fgdm_tpu_torch.utils import seg_metrics  # noqa: E402
from fgdm_tpu_torch.utils.clip_score import (CLIPScorer,  # noqa: E402
                                             CLIPVisionEncoder, flax_paths)
from test_torch_chain import CHAIN_TOL  # noqa: E402
from test_torch_cli import files  # noqa: E402,F401

torch.set_num_threads(2)

FWD_TOL = (1e-5, 1e-6)
VISION = dict(image_size=56, patch_size=14, hidden=64, layers=2, heads=2,
              proj_dim=32)
TEXT = dict(vocab_size=49408, embed_dim=48, num_layers=1, num_heads=4)
VIT_L = dict(image_size=224, patch_size=14, hidden=1024, layers=24,
             heads=16, proj_dim=768)
SCORE_TOL = 1e-5


def close(got, ref, tol=FWD_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = tol[0] * np.abs(ref).max() + tol[1]
    assert err <= lim, (err, lim)


# --- the numpy metrics ------------------------------------------------------

def _equal(got, ref):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _equal(got[k], ref[k])
    elif isinstance(ref, tuple):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _equal(a, b)
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def _metric_cases():
    rng = np.random.default_rng(40)
    pred = rng.integers(0, 7, (3, 17, 13))
    gt = rng.integers(0, 7, (3, 17, 13))
    gt[rng.random(gt.shape) < 0.1] = 255
    cm = jseg.confusion_matrix(pred, gt, 7, ignore_label=255)
    colors = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    depth_p, depth_g = rng.random((2, 12, 10)), rng.random((2, 12, 10))
    mask = rng.random((2, 12, 10)) > 0.2
    normals = rng.normal(size=(2, 2, 12, 10, 3))
    edges = rng.random((2, 2, 16, 16))
    skel = (rng.random((2, 2, 24, 20, 3)) > 0.9).astype(np.float32)
    boxes = rng.uniform(0, 50, (2, 5, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    return {
        "confusion": ("confusion_matrix", (pred, gt, 7),
                      {"ignore_label": 255}),
        "miou": ("miou_from_confusion", (cm,), {}),
        "colorized": ("labels_from_colorized", (colors, ade_cmap()[1:]), {}),
        "colorized255": ("labels_from_colorized",
                         (colors * 255, ade_cmap()[1:]), {}),
        "align": ("scale_shift_align", (depth_p, depth_g, mask), {}),
        "depth": ("depth_adherence", (depth_p, depth_g), {}),
        "depth_masked": ("depth_adherence", (depth_p, depth_g, mask), {}),
        "normal": ("normal_angular_error", tuple(normals), {}),
        "edge": ("edge_f1", tuple(edges), {}),
        "skeleton": ("skeleton_f1", tuple(skel), {}),
        "skeleton_tol0": ("skeleton_f1", tuple(skel), {"tol": 0}),
        "iou": ("bbox_iou", tuple(boxes), {}),
        "xywh": ("bbox_xywh_to_xyxy", (boxes[0],), {}),
        "xyxy": ("bbox_xyxy_to_xywh", (boxes[1][0],), {}),
        "clip": ("bbox_clip_xyxy", (boxes[0], 30, 40), {}),
        "center": ("box_to_center_scale", (3.0, 4.0, 20.0, 7.0), {}),
        "box": ("center_scale_to_box", (np.array([5.0, 6.0], np.float32),
                                        np.array([8.0, 3.0], np.float32)),
                {}),
    }


_MODULES = {"confusion": "seg", "miou": "seg", "colorized": "seg",
            "colorized255": "seg", "align": "depth", "depth": "depth",
            "depth_masked": "depth", "normal": "depth", "edge": "edge",
            "skeleton": "pose", "skeleton_tol0": "pose"}


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_numpy_metric_matches_jax_bit_for_bit(case):
    name, args, kw = _metric_cases()[case]
    pkg = _MODULES.get(case, "bbox")
    port = {"seg": seg_metrics, "depth": depth_metrics, "edge": edge_metrics,
            "pose": pose_metrics, "bbox": bbox}[pkg]
    ref_mod = {"seg": jseg, "depth": jdepth, "edge": jedge, "pose": jpose,
               "bbox": jbbox}[pkg]
    _equal(getattr(port, name)(*args, **kw), getattr(ref_mod, name)(*args,
                                                                     **kw))


def test_feature_stats_and_frechet_distance_match_jax_bit_for_bit():
    rng = np.random.default_rng(41)
    a, b = fid.FeatureStats(6), jfid.FeatureStats(6)
    for n in (5, 3, 9):
        x = rng.normal(size=(n, 6)).astype(np.float32)
        a.update(x)
        b.update(x)
    _equal((a.mean, a.cov), (b.mean, b.cov))
    other = rng.normal(size=(12, 6)) * 2.0 + 0.5
    s2, j2 = fid.FeatureStats(6), jfid.FeatureStats(6)
    s2.update(other)
    j2.update(other)
    _equal(fid.frechet_distance(a.mean, a.cov, s2.mean, s2.cov),
           jfid.frechet_distance(b.mean, b.cov, j2.mean, j2.cov))
    # a singular product takes the eps branch
    z = np.zeros((6, 6))
    _equal(fid.frechet_distance(a.mean, z, s2.mean, z),
           jfid.frechet_distance(b.mean, z, j2.mean, z))
    fn = lambda im: im.reshape(im.shape[0], -1)[:, :6]  # noqa: E731
    imgs = [rng.random((4, 2, 2, 3)) for _ in range(4)]
    _equal(fid.compute_fid(imgs[:2], imgs[2:], fn, 6),
           jfid.compute_fid(imgs[:2], imgs[2:], fn, 6))


def test_full_f32_turns_tf32_off_and_restores():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# --- Inception --------------------------------------------------------------

@pytest.fixture(scope="module")
def inc():
    params = jinception.init_inception_params(3)
    fn, dim = jinception.inception_feature_fn(params)
    net = inception.ingest_inception(inception.init_inception_params(3),
                                     device="cpu")
    return dict(jparams=params, jfn=fn, net=net,
                fn=inception.inception_feature_fn(net)[0])


def test_init_inception_params_are_jax_draws_in_oihw(inc):
    port = inception.init_inception_params(3)
    assert list(port) == jinception.expected_inception_keys()
    for k, v in jinception.ingest_inception(port).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(inc["jparams"][k]))


@pytest.mark.parametrize("hw", [64, 512])
def test_inception_features_match_jax(inc, hw):
    """Pool3 at batch 1: 64^2 grows to 299^2, 512^2 shrinks (JAX's resize
    antialiases there; a plain bilinear is off by ~0.5)."""
    x = np.random.default_rng(42 + hw).uniform(0, 1, (1, hw, hw, 3)).astype(
        np.float32)
    got, ref = inc["fn"](x), inc["jfn"](x)
    assert got.shape == (1, 2048) and ref.std() > 0.1
    close(got, ref)


def _torchvision_file(params, path, drop=None):
    sd = {k: torch.from_numpy(v) for k, v in params.items() if k != drop}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    torch.save(sd, path)
    return str(path)


def test_inception_torchvision_file_loads_and_a_missing_key_raises(
        inc, tmp_path):
    params = inception.init_inception_params(3)
    path = _torchvision_file(params, tmp_path / "pt_inception.pth")
    sd = load_torch_state_dict(path)
    net = inception.ingest_inception(sd, device="cpu")
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), params[k])
    bad = load_torch_state_dict(_torchvision_file(
        params, tmp_path / "bad.pth", drop="Mixed_6b.branch7x7_2.bn.bias"))
    with pytest.raises(KeyError) as got:
        inception.ingest_inception(bad, device="cpu")
    with pytest.raises(KeyError) as ref:
        jinception.ingest_inception({k: v.numpy() for k, v in bad.items()})
    assert str(got.value) == str(ref.value)


# --- CLIP -------------------------------------------------------------------

def to_flax(module):
    """A port tower's weights as JAX's flax tree (through ``flax_paths``)."""
    sd = module.state_dict()
    tree = {}
    for path, key in flax_paths(module).items():
        v = sd[key].numpy()
        if path.endswith("kernel"):
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return {"params": tree}


@pytest.fixture(scope="module")
def towers():
    gen = torch.Generator().manual_seed(43)
    vision = CLIPVisionEncoder(**VISION, device="cpu")
    init_params_(vision, gen, 0.02)
    vision.reset_parameters(gen)
    text = init_params_(CLIPTextEncoder(**TEXT, device="cpu"), gen, 0.02)
    proj = torch.randn(TEXT["embed_dim"], VISION["proj_dim"], generator=gen)
    jv, jt = jclip.CLIPVisionEncoder(**VISION), JText(**TEXT)
    jscorer = jclip.CLIPScorer(to_flax(vision), to_flax(text),
                               jnp.asarray(proj.numpy()), vision_def=jv,
                               text_def=jt)
    return dict(vision=vision, text=text, proj=proj, jv=jv, jt=jt,
                jscorer=jscorer, scorer=CLIPScorer(vision, text, proj))


@pytest.fixture(scope="module")
def clip_batch():
    rng = np.random.default_rng(44)
    imgs = rng.uniform(0, 1, (3, 70, 48, 3)).astype(np.float32)
    ids = CLIPTokenizer()(["a red cube", "two dogs on a beach", "x"])
    return imgs, ids


def test_flax_paths_name_every_parameter_as_jax(towers):
    for module, jdef, x in ((towers["vision"], towers["jv"],
                             jnp.zeros((1, 56, 56, 3))),
                            (towers["text"], towers["jt"],
                             jnp.zeros((1, 77), jnp.int32))):
        expect = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0), x))
        flat = {"/".join(k): v.shape
                for k, v in _flat(expect["params"]).items()}
        paths = flax_paths(module)
        assert set(paths) == set(flat)
        sd = module.state_dict()
        for p, k in paths.items():
            shape = tuple(sd[k].shape)
            if p.endswith("kernel"):
                shape = (shape[2:] + shape[1::-1] if len(shape) == 4
                         else shape[::-1])
            assert shape == tuple(flat[p]), p


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def test_vision_tower_and_scores_match_jax(towers, clip_batch):
    """The 56^2 resize (bicubic: grows on one axis, shrinks on the other),
    the tower, the pooled text features and the per-sample cosine."""
    imgs, ids = clip_batch
    got = towers["scorer"].encode_image(imgs).numpy()
    ref = np.asarray(towers["jscorer"]._encode_image(
        towers["jscorer"].vision_params, jnp.asarray(imgs)))
    close(got, ref, (SCORE_TOL, 0))
    jids = jnp.asarray(JTokenizer()(["a red cube", "two dogs on a beach",
                                     "x"]))
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    got_t = towers["scorer"].encode_text(ids).numpy()
    ref_t = np.asarray(towers["jscorer"]._encode_text(
        towers["jscorer"].text_params, towers["jscorer"].text_proj, jids))
    close(got_t, ref_t, (SCORE_TOL, 0))
    got_s = towers["scorer"].score(imgs, ids)
    ref_s = np.asarray(towers["jscorer"].score(jnp.asarray(imgs), jids))
    assert np.abs(ref_s).max() > 1e-3
    np.testing.assert_allclose(got_s, ref_s, atol=SCORE_TOL, rtol=0)


def _layer_hf(sd, src, dst):
    out = {}
    for k, v in sd.items():
        if k.startswith(src):
            out[dst + k[len(src):]] = v.clone()
    return out


def hf_file(towers):
    """The seeded towers as an HF ``CLIPModel`` state dict."""
    sd = {k: v.clone() for k, v in towers["text"].state_dict().items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    vsd = towers["vision"].state_dict()
    pre = "vision_model."
    sd[pre + "embeddings.class_embedding"] = vsd["class_embedding"].clone()
    sd[pre + "embeddings.patch_embedding.weight"] = vsd[
        "patch_embed.weight"].clone()
    sd[pre + "embeddings.position_embedding.weight"] = vsd[
        "position_embedding"].clone()
    sd[pre + "embeddings.position_ids"] = torch.arange(17)[None]
    sd[pre + "pre_layrnorm.weight"] = vsd["pre_layernorm.weight"].clone()
    sd[pre + "pre_layrnorm.bias"] = vsd["pre_layernorm.bias"].clone()
    sd.update(_layer_hf(vsd, "layers.", pre + "encoder.layers."))
    sd[pre + "post_layernorm.weight"] = vsd["post_layernorm.weight"].clone()
    sd[pre + "post_layernorm.bias"] = vsd["post_layernorm.bias"].clone()
    sd["visual_projection.weight"] = vsd["visual_projection.weight"].clone()
    sd["text_projection.weight"] = towers["proj"].T.contiguous()
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd


def openai_file(hf, n_text, n_vision, visual_proj=True):
    """An HF state dict in OpenAI's schema (fused ``in_proj``, ``visual.*``,
    ``positional_embedding``, ``text_projection`` ``[embed, proj]``); with
    ``visual_proj=False`` the vision projection stays HF's
    ``visual_projection.weight``."""
    oa = {"positional_embedding":
          hf["text_model.embeddings.position_embedding.weight"],
          "text_projection": hf["text_projection.weight"].T.contiguous(),
          "logit_scale": hf["logit_scale"]}
    v = "vision_model."
    oa["visual.class_embedding"] = hf[v + "embeddings.class_embedding"]
    oa["visual.positional_embedding"] = hf[
        v + "embeddings.position_embedding.weight"]
    if visual_proj:
        oa["visual.proj"] = hf["visual_projection.weight"].T.contiguous()
    else:
        oa["visual_projection.weight"] = hf["visual_projection.weight"]
    oa["visual.conv1.weight"] = hf[v + "embeddings.patch_embedding.weight"]
    oa["visual.ln_pre.weight"] = hf[v + "pre_layrnorm.weight"]
    oa["visual.ln_pre.bias"] = hf[v + "pre_layrnorm.bias"]

    def blocks(src, dst, n):
        for i in range(n):
            s, t = f"{src}encoder.layers.{i}.", f"{dst}resblocks.{i}."
            for leaf in ("weight", "bias"):
                oa[t + f"attn.in_proj_{leaf}"] = torch.cat(
                    [hf[s + f"self_attn.{x}_proj.{leaf}"] for x in "qkv"])
                oa[t + f"attn.out_proj.{leaf}"] = hf[
                    s + f"self_attn.out_proj.{leaf}"]
                oa[t + f"ln_1.{leaf}"] = hf[s + f"layer_norm1.{leaf}"]
                oa[t + f"mlp.c_fc.{leaf}"] = hf[s + f"mlp.fc1.{leaf}"]
                oa[t + f"mlp.c_proj.{leaf}"] = hf[s + f"mlp.fc2.{leaf}"]
                oa[t + f"ln_2.{leaf}"] = hf[s + f"layer_norm2.{leaf}"]

    blocks(v, "visual.transformer.", n_vision)
    oa["visual.ln_post.weight"] = hf[v + "post_layernorm.weight"]
    oa["visual.ln_post.bias"] = hf[v + "post_layernorm.bias"]
    blocks("text_model.", "transformer.", n_text)
    oa["token_embedding.weight"] = hf[
        "text_model.embeddings.token_embedding.weight"]
    oa["ln_final.weight"] = hf["text_model.final_layer_norm.weight"]
    oa["ln_final.bias"] = hf["text_model.final_layer_norm.bias"]
    return oa


def _both_ingest(sd, towers):
    """Each package's ``ingest_clip_towers`` -> its scorer (or the
    ``SystemExit`` text), and the matcher's slot choices."""
    out = {}
    for pkg in ("jax", "port"):
        maps, fuzz = [], (jfuzzy if pkg == "jax" else fuzzy_ingest)
        orig = fuzz.match_state_dict

        def spy(s, e, orig=orig, maps=maps):
            r = orig(s, e)
            maps.append(r[0])
            return r

        fuzz.match_state_dict = spy
        try:
            if pkg == "jax":
                vp, tp, proj = jeval.ingest_clip_towers(
                    {k: v.numpy() for k, v in sd.items()}, towers["jv"],
                    towers["jt"])
                scorer = jclip.CLIPScorer(vp, tp, jnp.asarray(proj),
                                          vision_def=towers["jv"],
                                          text_def=towers["jt"])
            else:
                vision = CLIPVisionEncoder(**VISION, device="cpu")
                text = CLIPTextEncoder(**TEXT, device="cpu")
                vp, tp, proj = teval.ingest_clip_towers(dict(sd), vision,
                                                        text)
                vision.load_state_dict(vp)
                text.load_state_dict(tp)
                scorer = CLIPScorer(vision, text, proj)
            out[pkg] = (scorer, maps)
        except SystemExit as e:
            out[pkg] = (str(e), maps)
        finally:
            fuzz.match_state_dict = orig
    return out


@pytest.mark.parametrize("schema", ["hf", "openai"])
def test_clip_files_load_into_the_slots_jax_gives_and_score_the_same(
        schema, towers, clip_batch):
    """OpenAI's file stores its vision projection as HF does here: JAX's
    matcher has no slot for a bare ``visual.proj`` (the next test).  On
    the OpenAI schema JAX's tie rule swaps each layer's ``ln_1.bias`` and
    ``mlp.c_proj.bias`` (ROADMAP Queue C); the port reproduces it."""
    hf = hf_file(towers)
    sd = hf if schema == "hf" else openai_file(hf, 1, 2, visual_proj=False)
    res = _both_ingest(sd, towers)
    (scorer, maps), (jscorer, jmaps) = res["port"], res["jax"]
    assert maps == jmaps and len(maps) == 2
    imgs, ids = clip_batch
    got = scorer.score(imgs, ids)
    ref = np.asarray(jscorer.score(jnp.asarray(imgs), jnp.asarray(
        ids.numpy())))
    np.testing.assert_allclose(got, ref, atol=SCORE_TOL, rtol=0)
    if schema == "hf":
        # the HF file puts every tensor back where it came from
        for key, v in towers["vision"].state_dict().items():
            assert torch.equal(scorer.vision.state_dict()[key], v), key
        np.testing.assert_allclose(got, towers["scorer"].score(imgs, ids),
                                   atol=0, rtol=0)
    else:
        swapped = {tk: p for tk, p in maps[1].items()
                   if tk.endswith(("ln_1.bias", "c_proj.bias"))}
        assert swapped == {
            "transformer.resblocks.0.ln_1.bias": "layers_0/fc2/bias",
            "transformer.resblocks.0.mlp.c_proj.bias":
                "layers_0/layer_norm1/bias"}


def _refused(sd, towers):
    res = _both_ingest(sd, towers)
    assert isinstance(res["jax"][0], str), "JAX loaded the file"
    assert res["port"][0] == res["jax"][0]
    return res["jax"][0]


@pytest.mark.parametrize("case", ["missing", "extra", "visual_proj",
                                  "no_projection"])
def test_clip_ingest_refuses_as_jax(case, towers):
    hf = hf_file(towers)
    if case == "missing":
        del hf["vision_model.encoder.layers.1.mlp.fc2.bias"]
        want = "tower params left at random init"
    elif case == "extra":
        hf["text_model.encoder.layers.0.extra.weight"] = torch.zeros(3, 5)
        want = "1 unconsumed ckpt params"
    elif case == "visual_proj":
        hf = openai_file(hf, 1, 2, visual_proj=True)
        want = "visual.proj"
    else:
        del hf["text_projection.weight"]
        want = "lacks text_projection"
    assert want in _refused(hf, towers)


def _zeros(shape):
    return np.broadcast_to(np.float32(0), shape)


@pytest.mark.parametrize("schema", ["hf", "openai"])
def test_clip_slots_at_vit_l_widths_match_jax(schema):
    """The matcher's choices at the ViT-L/14 towers (24 vision layers, 12
    text layers: ``layers_10`` sorts before ``layers_2`` in JAX's tree), on
    shapes alone (zero-stride arrays, modules on the meta device)."""
    vision = CLIPVisionEncoder(**VIT_L, device="meta")
    text = CLIPTextEncoder(device="meta")
    shapes = {}
    for prefix, module in (("vision_model.", vision), ("", text)):
        for k, v in module.state_dict().items():
            shapes[k] = tuple(v.shape)
    hf = {}
    for k, s in shapes.items():
        if k in ("class_embedding", "position_embedding"):
            k = "vision_model.embeddings." + {
                "class_embedding": "class_embedding",
                "position_embedding": "position_embedding.weight"}[k]
        elif k == "patch_embed.weight":
            k = "vision_model.embeddings.patch_embedding.weight"
        elif k.startswith("pre_layernorm"):
            k = "vision_model.pre_layrnorm." + k.split(".")[-1]
        elif k.startswith(("layers.", "post_layernorm")):
            k = "vision_model." + ("encoder." if k.startswith("layers.")
                                   else "") + k
        hf[k] = torch.from_numpy(_zeros(s))
    hf["text_projection.weight"] = torch.from_numpy(_zeros((768, 768)))
    hf["logit_scale"] = torch.tensor(2.6592)
    sd = hf if schema == "hf" else openai_file(hf, 12, 24,
                                               visual_proj=False)
    jv, jt = jclip.CLIPVisionEncoder(), JText()
    split = {}
    # the ingest's own split and drop, then each tower's matcher
    parts = _split(sd)
    for label, sub, module, jdef, x in (
            ("vision", parts[0], vision, jv, jnp.zeros((1, 224, 224, 3))),
            ("text", parts[1], text, jt, jnp.zeros((1, 77), jnp.int32))):
        expect = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0), x))
        jmap, jt_un, jf_un = jfuzzy.match_state_dict(
            {k: v.numpy() for k, v in sub.items()}, expect)
        slots = flax_paths(module)
        own = module.state_dict()
        got = fuzzy_ingest.match_state_dict(
            sub, {p: tuple(own[k].shape) for p, k in slots.items()})
        assert got == (jmap, jt_un, jf_un), label
        assert not jt_un and not jf_un
        split[label] = jmap
    if schema == "openai":
        # JAX's tie rule scatters OpenAI's biases (ROADMAP Queue C)
        assert split["text"]["transformer.resblocks.0.ln_1.bias"] == \
            "layers_0/fc2/bias"
        assert split["text"]["transformer.resblocks.2.mlp.c_proj.bias"] \
            == "layers_10/self_attn/k_proj/bias"


def _split(sd):
    """``ingest_clip_towers``'s fused-qkv split, drop and tower routing."""
    out = {}
    for k, v in sd.items():
        if k.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
            stem = k.replace("in_proj_weight", "").replace("in_proj_bias",
                                                           "")
            leaf = "weight" if k.endswith("weight") else "bias"
            for x, part in zip("qkv", v.chunk(3, 0)):
                out[f"{stem}{x}_proj.{leaf}"] = part
        elif not k.endswith(("position_ids", "logit_scale")):
            out[k] = v
    vis = {k: v for k, v in out.items() if "visual" in k or "vision" in k}
    txt = {k: v for k, v in out.items() if not (
        "visual" in k or "vision" in k or "text_projection" in k)}
    return vis, txt


# --- the CLI ----------------------------------------------------------------

N_IMAGES = 36     # > the toy CLIP's 32 features: full-rank FID covariances


def _write(d, arrs):
    os.makedirs(d, exist_ok=True)
    for i, a in enumerate(arrs):
        Image.fromarray(a).save(os.path.join(d, f"{i:03}.png"))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Generated images that are colorized ADE maps (the toy segmenter
    reads them back), requested maps of every family and real images."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(45)
    cmap = ade_cmap()[1:]
    labs = rng.integers(0, 6, (N_IMAGES, 4, 4)).repeat(8, 1).repeat(8, 2)
    gen = np.stack([colorize(lab, cmap) for lab in labs])
    cond = labs.copy()
    cond[:, :8] = rng.integers(0, 6, (N_IMAGES, 8, 32))
    out = {"gen": _write(root / "gen", gen),
           "cond": _write(root / "cond", [colorize(c, cmap) for c in cond]),
           "ref": _write(root / "ref", rng.integers(
               0, 256, (N_IMAGES, 32, 32, 3), dtype=np.uint8))}
    for name, hw in (("depth", 24), ("normal", 32), ("sketch", 40),
                     ("pose", 32)):
        maps = rng.integers(0, 256, (N_IMAGES, hw, hw, 3), dtype=np.uint8)
        if name == "pose":
            maps[rng.random(maps.shape[:3]) < 0.9] = 0
        out[name] = _write(root / name, maps)
    prompts = root / "prompts.txt"
    prompts.write_text("\n".join(f"prompt number {i}"
                                 for i in range(N_IMAGES)))
    out["prompts"] = str(prompts)
    return out


def _toys(pkg, towers):
    """The injected factories: each package's scorer from the same seeded
    towers, the rest shared numpy toys."""
    seg = jseg if pkg == "jax" else seg_metrics
    cmap = ade_cmap()[1:]
    scorer = ((towers["jscorer"], JTokenizer()) if pkg == "jax"
              else (towers["scorer"], CLIPTokenizer()))
    return dict(
        scorer_factory=lambda opt: scorer,
        segmenter_factory=lambda opt: (
            lambda im: seg.labels_from_colorized(im * 255.0, cmap), 150,
            cmap),
        depth_factory=lambda opt: lambda im: im.mean(-1),
        normal_factory=lambda opt: lambda im: im * 2.0 - 1.0,
        sketch_factory=lambda opt: lambda im: im[..., 1],
        pose_factory=lambda opt: lambda im: im[:, ::-1])


def _both_mains(argv, towers, port_extra=()):
    ref = jeval.main(argv, **_toys("jax", towers))
    got = teval.main(argv + ["--device", "cpu", *port_extra],
                     **_toys("port", towers))
    assert got.keys() == ref.keys()
    return got, ref


def test_main_scores_a_directory_as_jax(dirs, towers, tmp_path):
    """Every metric but Inception-FID: CLIP score, CLIP-FID, mIoU, depth,
    normal, edge-F1, skeleton-F1, through both CLIs' ``main``."""
    argv = ["--images_dir", dirs["gen"], "--from-file", dirs["prompts"],
            "--ref_dir", dirs["ref"], "--cond_dir", dirs["cond"],
            "--depth_dir", dirs["depth"], "--normal_dir", dirs["normal"],
            "--sketch_dir", dirs["sketch"], "--pose_dir", dirs["pose"]]
    got, ref = _both_mains(argv + ["--out", str(tmp_path / "m.json")],
                           towers)
    assert {"clip_score", "fid", "fid_backend", "miou", "miou_classes",
            "depth_rmse_ssi", "depth_mae_ssi", "normal_mean_angle_deg",
            "normal_median_angle_deg", "sketch_f1", "pose_f1"} <= set(ref)
    assert ref["fid_backend"] == got["fid_backend"] == "clip"
    assert ref["n_images"] == got["n_images"] == N_IMAGES
    assert 0.0 < ref["miou"] < 1.0 and ref["fid"] > 0
    for k, v in ref.items():
        if k == "fid":
            assert got[k] == pytest.approx(v, rel=1e-4), k
        elif k != "fid_backend":
            assert abs(got[k] - v) <= 1e-6 * max(1.0, abs(v)), k
    import json

    assert json.loads((tmp_path / "m.json").read_text()) == got


def test_default_fid_backend_inception_matches_jax(dirs, tmp_path):
    """``--inception_ckpt``'s backend (a torchvision-schema file) in both
    CLIs: the same label and width, pool3 features within ``FWD_TOL`` on
    the directory's 32^2 images in ``main``'s batches of 16.  ``main``
    hands them to ``compute_fid``, bit for bit JAX's on equal features
    (above); the CLIP-FID ``main`` test covers the rest of the path."""
    params = inception.init_inception_params(3)
    path = _torchvision_file(params, tmp_path / "pt_inception.pth")
    opt = teval.get_parser().parse_args(["--inception_ckpt", path,
                                         "--device", "cpu"])
    fn, dim, label = teval.default_fid_backend(opt, None)
    jfn, jdim, jlabel = jeval.default_fid_backend(opt, None)
    assert (dim, label) == (jdim, jlabel) == (2048, "inception_pool3")
    imgs = teval._load_dir_images(dirs["gen"])
    for i in range(0, len(imgs), 16):
        close(fn(imgs[i:i + 16]), jfn(imgs[i:i + 16]))


def _jax_x_T(seed, n_chunks, shape_nhwc):
    """The starts JAX's ``_generate`` draws: a split per chunk, then
    ``ddim_sample``'s own split."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n_chunks):
        rng, r = jax.random.split(rng)
        _, init = jax.random.split(r)
        out.append(np.asarray(jax.random.normal(init, shape_nhwc))
                   .transpose(0, 3, 1, 2))
    return out


def test_generate_matches_jax_with_its_x_T(files, tmp_path):
    (tmp_path / "p.txt").write_text("a red cube\na blue ball\nthird\n")
    argv = ["--config", files["f1.yaml"], "--ckpt", files["f1.pth"],
            "--from-file", str(tmp_path / "p.txt"), "--n_samples", "2",
            "--ddim_steps", "3", "--H", "32", "--W", "32", "--precision",
            "full", "--seed", "7"]
    jopt = jeval.get_parser().parse_args(
        argv + ["--outdir", str(tmp_path / "jax")])
    ref, jprompts = jeval._generate(jopt, JTokenizer())
    opt = teval.get_parser().parse_args(
        argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    got, prompts = teval._generate(opt, CLIPTokenizer(),
                                   x_T=_jax_x_T(7, 2, (2, 4, 4, 4)))
    assert prompts == jprompts == ["a red cube", "a blue ball", "third"]
    assert got.shape == ref.shape == (3, 32, 32, 3) and ref.std() > 1e-3
    np.testing.assert_allclose(got, ref, atol=CHAIN_TOL, rtol=0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_main_generates_and_scores(files, towers, tmp_path):
    (tmp_path / "p.txt").write_text("a red cube\na blue ball\nthird\n")
    m = teval.main(["--config", files["f1.yaml"], "--ckpt", files["f1.pth"],
                    "--from-file", str(tmp_path / "p.txt"), "--n_samples",
                    "2", "--ddim_steps", "2", "--H", "32", "--W", "32",
                    "--outdir", str(tmp_path / "gen"), "--device", "cpu"],
                   **_toys("port", towers))
    assert m["n_images"] == 3 and -1.0 <= m["clip_score"] <= 1.0
    assert len(os.listdir(tmp_path / "gen")) == 3


_EXITS = {
    "clip_ckpt": (["--prompt", "x"], "--clip_ckpt is required"),
    "seg_ckpt": (["--cond_dir", "gen"], "--cond_dir needs --seg_ckpt"),
    "midas_depth": (["--depth_dir", "gen"], "--depth_dir needs --midas"),
    "midas_normal": (["--normal_dir", "gen"], "--normal_dir needs --midas"),
    "pidinet_ckpt": (["--sketch_dir", "gen"], "needs --pidinet_ckpt"),
    "openpose_ckpt": (["--pose_dir", "gen"], "needs --openpose_ckpt"),
    "nothing": ([], "nothing to score"),
    "prompts": (["--from-file", "few"], "images vs 2 prompts"),
    "inception": (["--ref_dir", "gen", "--inception_ckpt", "nope.pth"],
                  "--inception_ckpt nope.pth not found"),
    "ckpt": (None, "not found — metrics on a random-init model"),
    "empty_dir": (["--ref_dir", "empty"], "no images under"),
    "cond_count": (["--cond_dir", "cond3", "--seg_ckpt", "seg"],
                   "images vs 3 condition maps"),
}


@pytest.mark.parametrize("case", list(_EXITS))
def test_system_exits_match_jax(case, dirs, towers, tmp_path):
    """Each CLI's refusal, with the default factories (the injected toy
    scorer where the case reaches past it)."""
    extra, want = _EXITS[case]
    sub = {"gen": dirs["gen"], "few": str(tmp_path / "few.txt"),
           "empty": str(tmp_path / "empty"), "cond3": str(tmp_path / "c3"),
           "seg": dirs["prompts"]}
    (tmp_path / "few.txt").write_text("one\ntwo\n")
    os.makedirs(tmp_path / "empty")
    _write(tmp_path / "c3", np.zeros((3, 8, 8, 3), np.uint8))
    if extra is None:
        argv = ["--ckpt", str(tmp_path / "missing.pth"), "--prompt", "x"]
    else:
        argv = ["--images_dir", dirs["gen"]] + [sub.get(a, a) for a in extra]
    msgs = []
    for pkg, mod in (("jax", jeval), ("port", teval)):
        kw = {} if case in ("clip_ckpt", "seg_ckpt", "cond_count") else {
            "scorer_factory": _toys(pkg, towers)["scorer_factory"]}
        if case == "cond_count":
            kw["segmenter_factory"] = _toys(pkg, towers)["segmenter_factory"]
        args = argv + (["--device", "cpu"] if pkg == "port" else [])
        with pytest.raises(SystemExit) as e:
            mod.main(args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and want in msgs[0], msgs


def test_default_sketch_factory_matches_jax(tmp_path):
    """``--pidinet_ckpt``'s edge function on a released-schema file: [0, 1]
    edges of the thresholded map; a pixel may differ only where JAX's
    unthresholded map is within 1e-4 of the threshold."""
    from test_torch_annotators import _seeded, reference_file

    module, _ = _seeded("pidinet", 46)
    path = reference_file("pidinet", module, tmp_path / "table5_pidinet.pth")
    imgs = np.random.default_rng(47).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    opt = teval.get_parser().parse_args(["--pidinet_ckpt", path,
                                         "--device", "cpu"])
    got = teval.default_sketch_factory(opt)(imgs)
    ref = jeval.default_sketch_factory(opt)(imgs)
    assert got.shape == ref.shape == (2, 64, 64)
    assert set(np.unique(got)) <= {0.0, 1.0} and 0 < ref.mean() < 1
    assert (got != ref).mean() <= 1e-3
