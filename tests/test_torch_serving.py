"""The port's serving engine and HTTP server: the contracts of
``tests/test_serving.py`` and ``tests/test_server.py`` on a tiny port engine,
plus the seed range of ``serving.py:65-68`` and the engine's CLIP contexts
against the JAX package.

The tiny pipelines use the geometries of ``tests/test_torch_chain.py`` with
seeded random weights (0.02 N(0, 1) on the UNets and ControlNet), float32 on
the CPU, and a one-layer CLIP converted from flax params.  Servers bind port
0 (an ephemeral port), so test files can run in parallel.

Tolerances: engine outputs bit-identical wherever the contract says so
(padding, slots, staged, PNG round trip); CLIP contexts 1e-4 * max(1,
max|ref|) against JAX, as the other whole-model tests.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.sampling.chain as jchain  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JCLIPTokenizer  # noqa: E402
from fgdm_tpu_torch import builders, server  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.serving import (ChainEngine,  # noqa: E402
                                    slot_seeds_from_seeds)
from test_torch_chain import TINY, VAE_TINY  # noqa: E402

torch.set_num_threads(2)

CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
KW = dict(max_batch=2, cond_hw=(64, 64), image_hw=(64, 64), f1_steps=2,
          f2_steps=2)


@pytest.fixture(scope="module")
def clip():
    """A tiny JAX CLIP and the port's copy of it."""
    jm = JCLIPTextEncoder(**CLIP_TINY)
    p = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 77), jnp.int32))
    tm = CLIPTextEncoder(**CLIP_TINY, device="cpu")
    tm.load_state_dict(convert.clip_state_dict(p), strict=True)
    return jm, p, tm.eval()


@pytest.fixture(scope="module")
def engine(clip):
    gen = torch.Generator().manual_seed(0)

    def seeded(m, perturb=0.02):
        return init_params_(m, gen, perturb).eval()

    f32 = dict(dtype=torch.float32, device="cpu")
    vae = seeded(AutoencoderKL(**VAE_TINY, **f32), 0.0)
    sched = builders.sd14_schedule()
    ld = LatentDiffusion(seeded(UNetModel(**TINY, **f32)), vae, sched,
                         clip=clip[2])
    cldm = ControlLDM(seeded(UNetModel(**TINY, use_adapter=False, **f32)),
                      vae, sched, clip=clip[2],
                      control=seeded(ControlNet(**TINY, **f32)),
                      control_scales=(1.0,) * 5)
    return ChainEngine(ld, cldm, **KW)


# --- the engine --------------------------------------------------------------

def test_generate_single(engine):
    assert engine.compile_seconds > 0   # the warmup ran one generate()
    out = engine.generate(["a cat"], seed=1)
    for key in ("images", "conditions"):
        assert out[key].shape == (1, 64, 64, 3)
        assert out[key].dtype == np.uint8
    assert out["images"].std() > 0


def test_generate_batch_and_padding(engine):
    out = engine.generate(["a cat", "a dog"], seed=2)
    assert out["images"].shape == (2, 64, 64, 3)
    out1 = engine.generate(["a cat"], seed=2)
    np.testing.assert_array_equal(out1["images"][0], out["images"][0])


def test_generate_rejects_overflow(engine):
    with pytest.raises(ValueError):
        engine.generate(["a"] * 3)
    with pytest.raises(ValueError):
        engine.generate([])


def test_seed_determinism(engine):
    a = engine.generate(["x"], seed=7)["images"]
    b = engine.generate(["x"], seed=7)["images"]
    c = engine.generate(["x"], seed=8)["images"]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_slot_invariance(engine):
    """A (prompt, seed) pair gives the same image in any slot of any
    batch."""
    solo = engine.generate(["a cat"], seed=7)
    slot0 = engine.generate(["a cat", "a dog"], seeds=[7, 3])
    slot1 = engine.generate(["a dog", "a cat"], seeds=[3, 7])
    np.testing.assert_array_equal(solo["images"][0], slot0["images"][0])
    np.testing.assert_array_equal(solo["images"][0], slot1["images"][1])
    np.testing.assert_array_equal(solo["conditions"][0],
                                  slot0["conditions"][0])
    dog = engine.generate(["a dog"], seed=3)
    np.testing.assert_array_equal(dog["images"][0], slot1["images"][0])


def test_per_request_seeds_validation(engine):
    with pytest.raises(ValueError):
        engine.generate(["a", "b"], seeds=[1])
    with pytest.raises(ValueError, match="outside"):
        engine.generate(["a"], seeds=[2 ** 63])


def test_negative_seed_runs_differs_and_is_slot_invariant(engine):
    neg = engine.generate(["a cat"], seeds=[-1])
    pos = engine.generate(["a cat"], seeds=[1])
    assert not np.array_equal(neg["images"], pos["images"])
    pair = engine.generate(["a dog", "a cat"], seeds=[5, -1])
    np.testing.assert_array_equal(pair["images"][1], neg["images"][0])
    np.testing.assert_array_equal(pair["conditions"][1],
                                  neg["conditions"][0])


@pytest.mark.parametrize("seed", [-2 ** 63 - 1, -2 ** 63, -1, 0, 2 ** 63 - 1,
                                  2 ** 63])
def test_slot_seeds_accept_the_jax_seed_range(seed):
    """The engine takes exactly the seeds ``jax.random.PRNGKey`` takes, and
    maps them to distinct non-negative slot seeds (s mod 2**64)."""
    try:
        jax.random.PRNGKey(seed)
        jax_ok = True
    except OverflowError:
        jax_ok = False
    if jax_ok:
        assert slot_seeds_from_seeds([seed]) == [seed % 2 ** 64]
    else:
        with pytest.raises(ValueError):
            slot_seeds_from_seeds([seed])
    assert jax_ok == (-2 ** 63 <= seed < 2 ** 63)


def test_staged_engine_matches_unstaged(engine):
    staged = ChainEngine(engine.ld, engine.cldm, tokenizer=engine.tok,
                         staged=True, warmup=False, **KW)
    a = engine.generate(["a cat", "a dog"], seed=3)
    b = staged.generate(["a cat", "a dog"], seed=3)
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["conditions"], b["conditions"])


def test_engine_fast_preset_sampler(engine):
    """``f1_sampler="dpm"`` gives valid output, differs from DDIM, and stays
    staged == unstaged."""
    kw = dict(KW, tokenizer=engine.tok, f1_sampler="dpm", warmup=False)
    fused = ChainEngine(engine.ld, engine.cldm, **kw)
    staged = ChainEngine(engine.ld, engine.cldm, staged=True, **kw)
    a = fused.generate(["a cat"], seed=3)
    assert a["images"].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(a["images"],
                                  staged.generate(["a cat"], seed=3)["images"])
    c = engine.generate(["a cat"], seed=3)
    assert not np.array_equal(a["conditions"], c["conditions"])


def test_mesh_serving_is_not_ported(engine):
    """Mesh serving is ported (tests/test_torch_parallel.py); a mesh whose
    ``data`` dim does not divide ``max_batch`` is refused with JAX's text
    (``serving.py:148-152``) before any collective runs."""
    class Dim:
        def size(self):
            return 3

    class Mesh:
        def __getitem__(self, name):
            return Dim()

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match="must divide over the data axis"):
        ChainEngine(engine.ld, engine.cldm, max_batch=4, mesh=Mesh(),
                    warmup=False)


def test_generate_from_a_worker_thread(engine):
    """The batcher calls generate() from its own thread, where inference
    mode is off; generate() turns it on itself."""
    out = {}
    th = threading.Thread(target=lambda: out.update(
        engine.generate(["a cat"], seed=11)))
    th.start()
    th.join(timeout=300)
    assert not th.is_alive()
    ref = engine.generate(["a cat"], seed=11)
    np.testing.assert_array_equal(out["images"], ref["images"])


def test_prompts_match_jax():
    assert (tchain.A_PROMPT, tchain.N_PROMPT) == (jchain.A_PROMPT,
                                                  jchain.N_PROMPT)


def test_contexts_match_jax(engine, clip):
    """``_contexts``: the padded prompt, empty, prompt + A_PROMPT and
    N_PROMPT contexts of ``serving.py:202-210``, from the same token ids
    through the same CLIP."""
    jm, p, _ = clip
    tok = JCLIPTokenizer()
    padded = ["a cat", ""]
    texts = (padded, ["", ""], [s + ", " + jchain.A_PROMPT for s in padded],
             [jchain.N_PROMPT] * 2)
    with torch.inference_mode():
        got = engine._contexts(["a cat"])
    for g, t in zip(got, texts):
        ref = np.asarray(jm.apply(p, jnp.asarray(tok(t))))
        assert g.shape == (2, 77, 64)
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


# --- the HTTP server ---------------------------------------------------------

def _start(engine, **kw):
    ready = threading.Event()
    th = threading.Thread(target=server.serve, args=(engine, "127.0.0.1", 0),
                          kwargs=dict(kw, ready=ready), daemon=True)
    th.start()
    assert ready.wait(30)
    return ready.server, th


@pytest.fixture(scope="module")
def port(engine):
    httpd, th = _start(engine)
    yield httpd.server_address[1]
    httpd.shutdown()
    th.join(timeout=30)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(port, payload, path="/generate", raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _decode(b64):
    from PIL import Image

    png = base64.b64decode(b64)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(png)))


def test_healthz(port):
    status, ctype, body = _get(port, "/healthz")
    body = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert body["status"] == "ok" and body["max_batch"] == 2
    assert body["compile_seconds"] > 0 and body["batch_window_ms"] == 0


def test_generate_pngs_equal_the_arrays(port, engine):
    status, body = _post(port, {"prompts": ["a cat", "a dog"],
                                "seeds": [3, -4]})
    assert status == 200 and body["latency_s"] > 0
    ref = engine.generate(["a cat", "a dog"], seeds=[3, -4])
    for key in ("images", "conditions"):
        assert len(body[key]) == 2
        for b64, arr in zip(body[key], ref[key]):
            np.testing.assert_array_equal(_decode(b64), arr)


def test_generate_rejects_bad_requests(port):
    cases = [({"prompts": []}, "prompts"), ({"prompts": "a cat"}, "prompts"),
             ({"prompts": ["a", "b", "c"]}, "at most 2"),
             ({"prompts": ["a", "b"], "seeds": [1]}, "seeds"),
             ({"prompts": ["a"], "seeds": ["1"]}, "seeds")]
    for payload, word in cases:
        status, body = _post(port, payload)
        assert status == 400 and word in body["error"], (payload, body)
    status, body = _post(port, None, raw=b"{not json")
    assert status == 400 and "invalid JSON" in body["error"]
    status, body = _post(port, {"prompts": ["a"]}, path="/nope")
    assert status == 404
    status, body = _post(port, {"prompts": ["a"], "seeds": [2 ** 64]})
    assert status == 500 and "ValueError" in body["error"]


def test_metrics_endpoint(port):
    _post(port, {"prompts": ["a cat"], "seed": 1})
    status, ctype, text = _get(port, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    vals = {line.split()[0]: float(line.split()[1])
            for line in text.decode().splitlines()
            if line and not line.startswith("#")}
    assert vals["fgdm_requests_total"] >= 1
    assert vals["fgdm_images_total"] >= 1
    assert vals["fgdm_max_batch"] == 2
    assert vals["fgdm_request_latency_seconds_sum"] > 0
    assert vals["fgdm_compile_seconds"] > 0


def test_batching_coalesces_concurrent_requests(engine):
    """Two concurrent requests with different seeds merge into ONE engine
    call, and each caller's slice equals its solo run."""
    calls = []

    class Counting:
        max_batch = engine.max_batch
        compile_seconds = engine.compile_seconds

        @staticmethod
        def generate(prompts, seed=0, seeds=None):
            calls.append((tuple(prompts), tuple(seeds or [])))
            return engine.generate(prompts, seed=seed, seeds=seeds)

    batcher = server.RequestBatcher(Counting, window_ms=2000)
    results, req_seeds = {}, {"a cat": 0, "a dog": -7}

    def hit(name):
        results[name] = batcher.generate([name], seed=req_seeds[name])

    threads = [threading.Thread(target=hit, args=(n,)) for n in req_seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(results) == set(req_seeds)
    assert len(calls) == 1 and len(calls[0][0]) == 2
    assert batcher.batches_run == 1
    for name, s in req_seeds.items():
        assert results[name]["images"].shape[0] == 1
        np.testing.assert_array_equal(
            results[name]["images"][0],
            engine.generate([name], seed=s)["images"][0])
    batcher.close()
    assert not batcher._thread.is_alive()


def test_batching_server_roundtrip(engine):
    """A threaded server with a batch window: two concurrent requests come
    back as valid PNGs from one engine batch (``/metrics`` counts it)."""
    httpd, th = _start(engine, max_requests=4, batch_window_ms=1500)
    p = httpd.server_address[1]
    assert json.loads(_get(p, "/healthz")[2])["batch_window_ms"] == 1500
    outs = {}

    def hit(name):
        outs[name] = _post(p, {"prompts": [name], "seed": 0})

    ts = [threading.Thread(target=hit, args=(n,)) for n in ("x", "y")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for status, body in outs.values():
        assert status == 200 and len(body["images"]) == 1
        assert _decode(body["images"][0]).shape == (64, 64, 3)
    text = _get(p, "/metrics")[2].decode()
    assert "fgdm_engine_batches_total 1" in text
    assert "fgdm_images_total 2" in text
    th.join(timeout=30)
    assert not th.is_alive()
    # serve() closed its batcher, whose thread no longer holds the engine
    assert not any(t.name == "fgdm-request-batcher" and t.is_alive()
                   for t in threading.enumerate())


def test_png_bytes_decode_to_the_array():
    from PIL import Image

    arr = np.random.default_rng(6).integers(0, 256, (5, 7, 3), np.uint8)
    img = Image.open(io.BytesIO(server.png_bytes(arr)))
    assert img.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(img), arr)


@pytest.mark.parametrize("arr", [np.zeros((5, 7), np.uint8),
                                 np.zeros((5, 7, 4), np.uint8),
                                 np.zeros((5, 7, 3), np.float32)],
                         ids=["gray", "rgba", "float"])
def test_png_bytes_takes_rgb_uint8_only(arr):
    with pytest.raises(ValueError, match="uint8"):
        server.png_bytes(arr)


def test_main_refuses_checkpoints(monkeypatch):
    """Checkpoints load now (``tests/test_torch_server_ckpt.py``), but not
    with the hash-fallback tokenizer: without a CLIP vocabulary and without
    ``FGDM_ALLOW_HASH_TOKENIZER=1``, ``check_production`` refuses them
    before anything is built, as JAX ``server.py:333-336`` does."""
    monkeypatch.delenv("FGDM_ALLOW_HASH_TOKENIZER", raising=False)
    monkeypatch.delenv("FGDM_CLIP_VOCAB_DIR", raising=False)
    for argv in (["--ckpt", "model.ckpt"], ["--cn_ckpt", "cn.pth"]):
        with pytest.raises(SystemExit, match="no CLIP vocab"):
            server.main(argv)
