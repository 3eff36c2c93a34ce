"""The port's server on reference checkpoints: ``server.build_engine``, the
assembly ``server.py --ckpt/--cn_ckpt`` runs, loads the tiny ``.pth`` files
of ``tests/test_torch_cli.py`` on the CPU (the loader's SD presets patched
to the tiny float32 modules those files hold), and the server answers one
request from them.  Without a
CLIP vocabulary and without ``FGDM_ALLOW_HASH_TOKENIZER=1`` the assembly
refuses the checkpoints (``check_production``), as JAX ``server.py:333-336``
does.
"""

import base64
import io
import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from fgdm_tpu_torch import server  # noqa: E402
from fgdm_tpu_torch.checkpoint import loader  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from test_torch_chain import TINY, VAE_TINY  # noqa: E402
from test_torch_cli import CLIP_TINY, files  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.fixture
def tiny_f32(files, monkeypatch):
    """The loader's presets as the tiny float32 modules of the files (the
    ``files`` fixture patches them to tiny modules in the loader's dtype,
    bf16 by default)."""
    monkeypatch.setattr(loader, "sd_unet", lambda dtype, device, **o: (
        UNetModel(**TINY, device=device, dtype=torch.float32, **o)))
    monkeypatch.setattr(loader, "sd_controlnet", lambda dtype, device: (
        ControlNet(**TINY, device=device, dtype=torch.float32)))
    monkeypatch.setattr(loader, "sd_vae", lambda dtype, device: (
        AutoencoderKL(**VAE_TINY, device=device, dtype=torch.float32)))
    monkeypatch.setattr(loader, "sd_clip", lambda dtype, device: (
        CLIPTextEncoder(**CLIP_TINY, device=device, dtype=torch.float32)))
    return files


def build(files, **kw):
    return server.build_engine(
        files["f1.pth"], files["cn.pth"], device="cpu", max_batch=1,
        cond_hw=(32, 32), image_hw=(64, 64), f1_steps=2, f2_steps=2, **kw)


def test_server_serves_from_checkpoints(tiny_f32):
    files = tiny_f32
    engine = build(files)
    assert engine.compile_seconds > 0       # the warmup ran
    for pipe, name, parts in (
            (engine.ld, "f1.pth", (("unet", ti.UNET_PREFIX),
                                   ("vae", ti.VAE_PREFIX),
                                   ("clip", ti.CLIP_PREFIX))),
            (engine.cldm, "cn.pth", (("unet", ti.UNET_PREFIX),
                                     ("control", ti.CONTROL_PREFIX)))):
        assert pipe.load_report["unexpected"] == []
        sd = torch.load(files[name], weights_only=True)["state_dict"]
        for attr, prefix in parts:
            assert pipe.load_report["missing"][attr] == []
            for k, v in getattr(pipe, attr).state_dict().items():
                assert torch.equal(v, sd[prefix + k]), prefix + k

    ready = threading.Event()
    th = threading.Thread(target=server.serve,
                          args=(engine, "127.0.0.1", 0),
                          kwargs=dict(max_requests=1, ready=ready),
                          daemon=True)
    th.start()
    assert ready.wait(30)
    port = ready.server.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompts": ["a cat"], "seed": 5}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        body = json.loads(r.read())
    th.join(30)
    assert not th.is_alive()
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        body["images"][0]))))
    cond = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        body["conditions"][0]))))
    assert img.shape == (64, 64, 3) and cond.shape == (32, 32, 3)
    assert img.std() > 0
    np.testing.assert_array_equal(
        img, engine.generate(["a cat"], seed=5)["images"][0])


def test_assembly_refuses_checkpoints_without_a_vocabulary(tiny_f32,
                                                           monkeypatch):
    files = tiny_f32
    monkeypatch.delenv("FGDM_ALLOW_HASH_TOKENIZER")
    monkeypatch.delenv("FGDM_CLIP_VOCAB_DIR", raising=False)
    with pytest.raises(SystemExit, match="no CLIP vocab"):
        build(files)
