"""The reference's kernel switches, read and routed by the port as by the
JAX package, on the CPU.

The JAX package reads ``FGDM_DISABLE_FLASH``, ``FGDM_FLASH_MIN_N``,
``FGDM_FLASH_BWD``, ``FGDM_FLASH_TRANSPOSED``, ``FGDM_FLASH_TRANSPOSE_MAX_D``
(``fgdm_tpu/kernels/attention.py:29,32,43,50,493``) and
``FGDM_DISABLE_PALLAS_CONV`` (``fgdm_tpu/kernels/conv.py:32``) once, at
import.  For each switch a subprocess sets it away from its default and
imports both packages; the port's module attributes must equal JAX's.  In
this process, with the attributes monkeypatched on both sides: the flash
gate follows ``_DISABLE_FLASH`` and ``_MIN_N`` as JAX's expression does
(``attention.py:665-673``), ``FlashAttention`` takes the recompute branch
where ``_flash_op_fwd`` takes the XLA VJP (``:640-644``) with gradients
that match ``jax.grad`` (atol 5e-3, rtol 1e-3, as
``tests/test_attention.py``), and the conv gates refuse every shape with
the kill switch set.
"""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.attention as ka  # noqa: E402
import fgdm_tpu.kernels.conv as kc  # noqa: E402
from fgdm_tpu_torch.kernels import attention as ta  # noqa: E402
from fgdm_tpu_torch.kernels import conv as tc  # noqa: E402

torch.set_num_threads(2)

HEAD_DIMS = (40, 80, 512)

# (variable, a value away from its default)
SWITCHES = [("FGDM_DISABLE_FLASH", "1"), ("FGDM_FLASH_MIN_N", "1024"),
            ("FGDM_FLASH_BWD", "0"), ("FGDM_FLASH_TRANSPOSED", "0"),
            ("FGDM_FLASH_TRANSPOSE_MAX_D", "64"),
            ("FGDM_DISABLE_PALLAS_CONV", "1")]

_READ = f"""
import json
import fgdm_tpu.kernels.attention as ka
import fgdm_tpu.kernels.conv as kc
from fgdm_tpu_torch.kernels import attention as ta, conv as tc
print(json.dumps({{
    "jax": [ka._DISABLE_FLASH, ka._FLASH_MIN_N, ka._FLASH_BWD,
            [ka._use_transposed(d) for d in {HEAD_DIMS}], kc._DISABLE],
    "port": [ta._DISABLE_FLASH, ta._MIN_N, ta._FLASH_BWD,
             [ta._use_flash_bwd(d) for d in {HEAD_DIMS}], tc._DISABLE]}}))
"""


def attributes(ka_, kc_, ta_, tc_):
    """Both packages' switch attributes, as ``_READ`` prints them."""
    return {"jax": [ka_._DISABLE_FLASH, ka_._FLASH_MIN_N, ka_._FLASH_BWD,
                    [ka_._use_transposed(d) for d in HEAD_DIMS],
                    kc_._DISABLE],
            "port": [ta_._DISABLE_FLASH, ta_._MIN_N, ta_._FLASH_BWD,
                     [ta_._use_flash_bwd(d) for d in HEAD_DIMS],
                     tc_._DISABLE]}


@pytest.fixture(scope="module")
def read_with_switch():
    """{variable: both packages' attributes in a process started with the
    variable set}; the subprocesses (imports only) run at once."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for name, value in SWITCHES:
        env = {k: v for k, v in os.environ.items()
               if k not in dict(SWITCHES)}
        env.update({name: value, "JAX_PLATFORMS": "cpu",
                    "PYTHONPATH": root + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", _READ], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_defaults_are_the_references():
    got = attributes(ka, kc, ta, tc)
    assert got["port"] == got["jax"]
    if not any(name in os.environ for name, _ in SWITCHES):
        assert got["port"] == [False, 512, True, [True, True, False], False]


@pytest.mark.parametrize("name,value", SWITCHES, ids=[n for n, _ in SWITCHES])
def test_switch_is_read_as_the_reference_reads_it(name, value,
                                                  read_with_switch):
    got = read_with_switch[name]
    assert got["port"] == got["jax"]
    # the switch moved something away from the default
    assert got["port"] != [False, 512, True, [True, True, False], False]


def fake(*shape):
    return types.SimpleNamespace(device=torch.device("cuda"), shape=shape)


@pytest.mark.parametrize("disable,min_n", [(False, 512), (True, 512),
                                           (False, 1024), (False, 256)])
@pytest.mark.parametrize("nq,nk", [(511, 512), (512, 512), (1000, 1024),
                                   (1024, 1024), (1024, 768), (256, 512),
                                   (4096, 4096)])
def test_flash_gate_follows_the_switches(disable, min_n, nq, nk,
                                         monkeypatch):
    """The port's gate against JAX's expression (``attention.py:665-673``
    less its backend test) under the same switch values."""
    for mod, attr in ((ka, "_FLASH_MIN_N"), (ta, "_MIN_N")):
        monkeypatch.setattr(mod, attr, min_n)
    for mod in (ka, ta):
        monkeypatch.setattr(mod, "_DISABLE_FLASH", disable)
    want = (not ka._DISABLE_FLASH and nq >= ka._FLASH_MIN_N
            and nk >= ka._FLASH_MIN_N and nk % 512 == 0)
    assert ta.flash_gate(nq, nk) is want
    assert ta.use_flash(fake(1, 8, nq, 40), fake(1, 8, nk, 40)) is want


@pytest.mark.parametrize("flash_bwd,max_d,want_kernels", [
    (True, 96, True), (False, 96, False), (True, 32, False)],
    ids=["default", "FGDM_FLASH_BWD=0", "FGDM_FLASH_TRANSPOSE_MAX_D=32"])
def test_flash_attention_backward_route_follows_the_switches(
        flash_bwd, max_d, want_kernels, monkeypatch):
    """``FlashAttention`` launches the flash backward only where
    ``_flash_op_fwd`` keeps lse; else it recomputes through
    ``attention_ref``, and its gradients match ``jax.grad`` through
    ``_flash_op`` (the XLA VJP there) under the same switches."""
    monkeypatch.setattr(ka, "_INTERPRET", True)
    for mod, attr in ((ka, "_TRANSPOSE_MAX_D"), (ta, "_TRANSPOSE_MAX_D")):
        monkeypatch.setattr(mod, attr, max_d)
    for mod in (ka, ta):
        monkeypatch.setattr(mod, "_FLASH_BWD", flash_bwd)
        monkeypatch.setattr(mod, "_FLASH_TRANSPOSED", True)
    calls = []
    real = ta.flash_attention_backward

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(ta, "flash_attention_backward", spy)
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2, 256, 40)).astype(np.float32)
               for _ in range(3))
    scale = 40 ** -0.5

    def loss(qq, kk, vv):
        return jnp.sum(ka._flash_op(qq, kk, vv, scale) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ta.multihead_attention(tq, tk, tv, scale, use_kernel=True)
    (out ** 2).sum().backward()
    assert bool(calls) is want_kernels
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-3,
                                   rtol=1e-3)
        assert math.isfinite(float(t.grad.abs().max()))


@pytest.mark.parametrize("gate,x,w", [
    ("conv3x3_ok", (8, 320, 32, 32), (320, 320, 3, 3)),
    ("conv3x3_ok", (8, 1280, 16, 16), (1280, 1280, 3, 3)),
    ("conv3x3_ok", (2, 136, 17, 23), (136, 136, 3, 3)),
    ("conv3x3_vae_ok", (1, 128, 512, 512), (128, 128, 3, 3)),
    ("conv3x3_vae_ok", (4, 128, 1024, 1024), (128, 128, 3, 3)),
])
def test_conv_gates_refuse_every_shape_with_the_kill_switch(gate, x, w,
                                                            monkeypatch):
    fn = getattr(tc, gate)
    assert fn(x, w, torch.bfloat16)
    monkeypatch.setattr(tc, "_DISABLE", True)
    assert not fn(x, w, torch.bfloat16)
    assert not fn(x, w, torch.float32)
