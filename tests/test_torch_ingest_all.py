"""The port's ingest report (``fgdm_tpu_torch/cli/ingest_all.py``) held
against the JAX package's ``tools/ingest_all.py`` on the CPU.

The weights directory is built as ``tests/test_ingest_all.py`` builds it,
in this file's own helpers: a tiny FG-DM factor file and a tiny ControlNet
stage file written through ``fgdm_tpu.checkpoint.torch_export`` (flax
shapes from ``jax.eval_shape``, numpy-seeded values, so no flax init runs),
a full-schema HED file, an InceptionV3 pool3 file and a toy BPE vocabulary.
Both tools run in process on the same directory: the JSON reports must be
equal family by family, and so must the exit codes, for the green
directory, a corrupt file, ``--require-all`` and an unknown family.  The
example key names are each package's own (JAX prints flax paths,
``params/block1/convs_0/bias``, the port torch names,
``block1.convs.0.bias``), so they are compared through that mapping.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.checkpoint import torch_export as jte  # noqa: E402
from fgdm_tpu_torch.cli import ingest_all as tia  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
UNET_TINY = dict(model_channels=32, num_heads=4, context_dim=64,
                 channel_mult=(1, 2), attention_resolutions=(1, 2),
                 num_res_blocks=1, dtype=jnp.float32)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_ingest_all", REPO / "tools" / "ingest_all.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), shapes)


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}, path)


def _build_fgdm_ckpt(path):
    from fgdm_tpu.models.autoencoder import AutoencoderKL
    from fgdm_tpu.models.clip import CLIPTextEncoder
    from fgdm_tpu.models.unet import UNetModel

    unet = UNetModel(**UNET_TINY)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                        resolution=64, dtype=jnp.float32)
    clip = CLIPTextEncoder(vocab_size=128, embed_dim=64, num_layers=2,
                           num_heads=4)
    sd = {}
    sd.update(jte.export_unet(_seeded(unet, 0, jnp.zeros((1, 8, 8, 4)),
                                      jnp.zeros((1,), jnp.int32),
                                      jnp.zeros((1, 77, 64)))))
    sd.update(jte.export_vae(_seeded(vae, 1, jnp.zeros((1, 64, 64, 3)),
                                     sample_posterior=False)))
    sd.update(jte.export_clip(_seeded(clip, 2,
                                      jnp.zeros((1, 77), jnp.int32))))
    _save_sd(sd, path)


def _build_cldm_ckpt(path):
    from fgdm_tpu.models.controlnet import ControlNet
    from fgdm_tpu.models.unet import UNetModel

    unet = UNetModel(**{**UNET_TINY, "use_adapter": False})
    cn = ControlNet(**UNET_TINY)
    sd = {}
    sd.update(jte.export_unet(_seeded(unet, 0, jnp.zeros((1, 8, 8, 4)),
                                      jnp.zeros((1,), jnp.int32),
                                      jnp.zeros((1, 77, 64)))))
    sd.update(jte.export_controlnet(_seeded(
        cn, 3, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))))
    _save_sd(sd, path)


def _build_hed_ckpt(path):
    """Full-schema ControlNetHED file (the reference's key names)."""
    from flax import traverse_util

    from fgdm_tpu.annotators.hed import ControlNetHED

    params = _seeded(ControlNetHED(), 4, jnp.zeros((1, 32, 32, 3)))
    sd = {}
    for p, v in traverse_util.flatten_dict(params["params"]).items():
        v = np.asarray(v)
        if p == ("norm",):
            sd["norm"] = v.reshape(1, 3, 1, 1)
            continue
        leaf = "weight" if p[-1] == "kernel" else "bias"
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if p[1].startswith("convs_"):
            sd[f"{p[0]}.convs.{p[1][-1]}.{leaf}"] = v
        else:
            sd[f"{p[0]}.projection.{leaf}"] = v
    _save_sd(sd, path)


def _build_inception_ckpt(path):
    from fgdm_tpu.utils.inception import _conv_specs

    rng = np.random.default_rng(5)
    sd = {}
    for name, cin, cout, kh, kw in _conv_specs():
        sd[f"{name}.conv.weight"] = rng.standard_normal(
            (cout, cin, kh, kw)).astype(np.float32)
        sd[f"{name}.bn.weight"] = np.ones(cout, np.float32)
        sd[f"{name}.bn.bias"] = np.zeros(cout, np.float32)
        sd[f"{name}.bn.running_mean"] = np.zeros(cout, np.float32)
        sd[f"{name}.bn.running_var"] = np.ones(cout, np.float32)
    _save_sd(sd, path)


def _build_vocab(d):
    tokens = {ch: i for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz ")}
    for extra in ("c a", "ca t</w>"):
        tokens["".join(extra.split())] = len(tokens)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(tokens, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version\nc a\nca t</w>\n")


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    _build_fgdm_ckpt(d / "fgdm_seg.pth")
    _build_cldm_ckpt(d / "fgdm_control_sd15_seg.pth")
    _build_hed_ckpt(d / "ControlNetHED.pth")
    _build_inception_ckpt(d / "pt_inception-2015-12-21-26bd7ee1.pth")
    _build_vocab(d)
    return d


@pytest.fixture(scope="module")
def jtool():
    return _jax_tool()


def _flax_name(torch_key: str) -> str:
    """A HED torch key as JAX's report names it."""
    block, kind, *rest = torch_key.split(".")
    if kind == "convs":
        return f"params/{block}/convs_{rest[0]}/{rest[1]}"
    return f"params/{block}/{kind}/{rest[0]}"


def _same(trep: dict, jrep: dict):
    """Equal reports, the example names compared through ``_flax_name``
    where they differ in spelling only."""
    assert set(trep) == set(jrep)
    for fam, j in jrep.items():
        t = dict(trep[fam])
        for k in ("missing_examples", "unexpected_examples"):
            if k in t and t[k] != j[k]:
                t[k] = [_flax_name(n) for n in t[k]]
        assert t == j, fam


def _run(main, args, out_json=None):
    """(exit code, report or None) of one tool's ``main``."""
    if out_json is not None:
        args = [*args, "--json", str(out_json)]
    try:
        rc = main(args)
    except SystemExit as e:   # argparse's error path
        rc = e.code
    report = (json.loads(pathlib.Path(out_json).read_text())
              if out_json is not None and os.path.exists(out_json) else None)
    return rc, report


@pytest.fixture(scope="module")
def green(weights_dir, jtool, tmp_path_factory):
    d = tmp_path_factory.mktemp("green")
    args = ["--weights_dir", str(weights_dir), "--geometry", "tiny"]
    return (_run(jtool.main, args, d / "jax.json"),
            _run(tia.main, args, d / "torch.json"))


def test_green_directory_reports_match_jax(green):
    (jrc, jrep), (trc, trep) = green
    assert trc == jrc == 0
    _same(trep, jrep)
    for fam in ("fgdm-seg", "control-seg", "hed", "clip-vocab", "inception"):
        assert trep[fam]["ok"] is True, (fam, trep[fam])
        assert trep[fam]["loaded"] > 0
    assert trep["uniformer"] == {"ok": None, "absent": True}


def test_corrupt_file_fails_like_jax(weights_dir, jtool, tmp_path):
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()
    sd = torch.load(weights_dir / "ControlNetHED.pth", weights_only=True)
    del sd[sorted(sd)[0]]
    torch.save(sd, bad_dir / "ControlNetHED.pth")
    args = ["--weights_dir", str(bad_dir), "--geometry", "tiny",
            "--families", "hed"]
    jrc, jrep = _run(jtool.main, args, tmp_path / "jax.json")
    trc, trep = _run(tia.main, args, tmp_path / "torch.json")
    assert trc == jrc == 1
    _same(trep, jrep)
    assert trep["hed"]["ok"] is False and trep["hed"]["missing"] == 1


def test_require_all_exit_code_matches_jax(weights_dir, jtool, tmp_path):
    """--require-all turns the absent families into a failing exit code;
    run on the families present plus one absent, so the present ones are
    not read a third time."""
    args = ["--weights_dir", str(weights_dir), "--geometry", "tiny",
            "--require-all", "--families", "hed,clip-vocab,midas"]
    jrc, jrep = _run(jtool.main, args, tmp_path / "jax.json")
    trc, trep = _run(tia.main, args, tmp_path / "torch.json")
    assert trc == jrc == 1
    _same(trep, jrep)
    assert trep["midas"] == {"ok": None, "absent": True}


def test_unknown_family_exit_code_matches_jax(weights_dir, jtool, capsys):
    args = ["--weights_dir", str(weights_dir), "--geometry", "tiny",
            "--families", "contro-seg"]
    jrc, _ = _run(jtool.main, args)
    jerr = capsys.readouterr().err
    trc, _ = _run(tia.main, args)
    terr = capsys.readouterr().err
    assert trc == jrc == 2
    assert "unknown families" in jerr and "unknown families" in terr


def test_adapter_key_on_a_plain_unet_is_unexpected_in_the_port(
        weights_dir, jtool, tmp_path):
    """The kept difference (``checkpoint/torch_ingest.py``): an FG-DM file
    read as the ControlNet stage meets a UNet without an adapter.  JAX's
    schema maps ``model.diffusion_model.adapter.*`` and drops it, so its
    ``control-seg`` report passes; the port counts the keys as unexpected
    and fails, as the reference's ``load_state_dict(strict=False)``
    reports them."""
    d = tmp_path / "mixed"
    d.mkdir()
    sd = torch.load(weights_dir / "fgdm_seg.pth", weights_only=True)
    cn = torch.load(weights_dir / "fgdm_control_sd15_seg.pth",
                    weights_only=True)
    adapter = {k: v for k, v in sd.items()
               if k.startswith("model.diffusion_model.adapter.")}
    assert adapter
    torch.save({**cn, **adapter}, d / "fgdm_control_sd15_seg.pth")
    args = ["--weights_dir", str(d), "--geometry", "tiny",
            "--families", "control-seg"]
    jrc, jrep = _run(jtool.main, args, tmp_path / "jax.json")
    trc, trep = _run(tia.main, args, tmp_path / "torch.json")
    assert (jrc, jrep["control-seg"]["ok"]) == (0, True)
    assert (trc, trep["control-seg"]["ok"]) == (1, False)
    assert trep["control-seg"]["unexpected"] == len(adapter)
    assert trep["control-seg"]["loaded"] == jrep["control-seg"]["loaded"]
    assert all(k.startswith("adapter.")
               for k in trep["control-seg"]["unexpected_examples"])


def test_report_loaded_counts_only_file_arrays(jtool):
    for rep in (jtool._report, tia._report):
        r = rep(10, ["a.adapter.w", "b.adapter.k"], [], adapter_ok=True)
        assert r["ok"] is True and r["loaded"] == 8 and r["missing"] == 2
