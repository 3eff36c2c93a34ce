"""One-command ingest report for every released checkpoint family.

Counterpart of ``tools/ingest_all.py``: the same families table, file
names, flags, report fields and exit code, run through the port's strict
loaders.

    python -m fgdm_tpu_torch.cli.ingest_all --weights_dir /path/to/models

It scans the directory for each family's known file name(s), reads the
file with the port's ingest for that family and prints, per file, the
arrays loaded and the missing and unexpected keys.  The exit code is
nonzero when a file that is present fails its strict ingest (absent
families are reported as absent; ``--require-all`` fails on those too).

* The LDM and ControlNet files go through ``checkpoint/torch_ingest.py``;
  UniFormer, MiDaS, PiDiNet, HED, MLSD and OpenPose body/hand through
  ``checkpoint/annotator_ingest.py``; ``vocab.json`` through the CLIP
  tokenizer; the Inception files through ``utils/inception.py``.
* Only the key sets and shapes are read where a model is built: every
  model is built on the ``meta`` device, so a 1-GB file needs no 1 GB of
  initialized parameters (loading into a meta module copies nothing).
  The Inception ingest checks its key list without building the network.
* ``loaded`` counts the arrays that came from the file: the model's
  state-dict entries less the missing ones, as JAX's count of assembled
  leaves less the init-filled ones.
* A key that the model lacks is unexpected here, also where JAX's schema
  maps it and then drops it (an ``adapter.*`` key meeting a UNet without
  an adapter; ``checkpoint/torch_ingest.py``'s docstring).

``--geometry tiny`` swaps the SD-sized definitions for the tiny geometry
of the tests (``tools/ingest_all.py:46-83``), so the plumbing runs on
synthetic reference-schema files.  The tool runs on the host's CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
import warnings

import torch

_META = torch.device("meta")


# --------------------------------------------------------------------------
# model-family geometry
# --------------------------------------------------------------------------

def _ldm_defs(geometry: str):
    from fgdm_tpu_torch.checkpoint.loader import sd_clip, sd_unet, sd_vae

    f32 = dict(dtype=torch.float32, device=_META)
    if geometry == "sd":
        return sd_unet(**f32), sd_vae(**f32), sd_clip(**f32)
    from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder
    from fgdm_tpu_torch.models.unet import UNetModel

    unet = UNetModel(model_channels=32, num_heads=4, context_dim=64,
                     channel_mult=(1, 2), attention_resolutions=(1, 2),
                     num_res_blocks=1, **f32)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                        resolution=64, **f32)
    clip = CLIPTextEncoder(vocab_size=128, embed_dim=64, num_layers=2,
                           num_heads=4, **f32)
    return unet, vae, clip


def _cldm_defs(geometry: str):
    from fgdm_tpu_torch.checkpoint.loader import sd_controlnet, sd_unet

    f32 = dict(dtype=torch.float32, device=_META)
    if geometry == "sd":
        return sd_unet(use_adapter=False, **f32), sd_controlnet(**f32)
    from fgdm_tpu_torch.models.controlnet import ControlNet
    from fgdm_tpu_torch.models.unet import UNetModel

    tiny = dict(model_channels=32, num_heads=4, context_dim=64,
                channel_mult=(1, 2), attention_resolutions=(1, 2),
                num_res_blocks=1, **f32)
    return UNetModel(use_adapter=False, **tiny), ControlNet(**tiny)


def _report(loaded: int, missing, unexpected, note: str = "",
            adapter_ok: bool = False) -> dict:
    """JAX's ``_report`` (``tools/ingest_all.py:90-111``): ``loaded``
    arrives as the model's entry count and is reported net of the missing
    (init-filled) ones; with ``adapter_ok`` missing adapter keys do not
    fail (plain SD files lack the FG-DM adapter)."""
    hard_missing = [k for k in missing
                    if not (adapter_ok and "adapter" in k)]
    ok = not hard_missing and not unexpected
    return {
        "ok": bool(ok),
        "loaded": max(0, int(loaded) - len(missing)),
        "missing": len(missing),
        "missing_examples": list(missing)[:5],
        "unexpected": len(unexpected),
        "unexpected_examples": list(unexpected)[:5],
        **({"note": note} if note else {}),
    }


def _n(module) -> int:
    return len(module.state_dict())


# --------------------------------------------------------------------------
# per-family runners: path -> report dict
# --------------------------------------------------------------------------

def run_ldm(path: str, geometry: str, adapter_ok: bool) -> dict:
    """SD-v1-x and fgdm_{seg,depth,normal,scribble} full LDM files."""
    from fgdm_tpu_torch.checkpoint import torch_ingest as ti

    unet, vae, clip = _ldm_defs(geometry)
    sd = ti.load_torch_state_dict(path)
    sd = ti.apply_key_surgery(sd, ignore_keys=("model_ema.",))
    m1, u1 = ti.ingest_unet(sd, unet)
    m2, u2 = ti.ingest_vae(sd, vae)
    m3, u3 = ti.ingest_clip(sd, clip)
    return _report(_n(unet) + _n(vae) + _n(clip), m1 + m2 + m3,
                   u1 + u2 + u3, adapter_ok=adapter_ok)


def run_cldm(path: str, geometry: str) -> dict:
    """fgdm_control_sd15_* ControlNet-stage files."""
    from fgdm_tpu_torch.checkpoint import torch_ingest as ti

    unet, cn = _cldm_defs(geometry)
    sd = ti.load_torch_state_dict(path)
    m1, u1 = ti.ingest_unet(sd, unet)
    m2, u2 = ti.ingest_controlnet(sd, cn)
    return _report(_n(unet) + _n(cn), m1 + m2, u1 + u2)


def _strict(name, path, module, ingest) -> dict:
    """JAX's ``load_*`` runners: any missing or unexpected key raises."""
    from fgdm_tpu_torch.checkpoint.annotator_ingest import _load

    return _report(_n(_load(name, path, module, ingest)), [], [])


def _lenient(path, module, ingest) -> dict:
    """JAX's ``ingest_*`` runners: the keys go into the report."""
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict

    missing, unexpected = ingest(load_torch_state_dict(path), module)
    return _report(_n(module), missing, unexpected)


def run_uniformer(path: str) -> dict:
    from fgdm_tpu_torch.annotators.uniformer import UniFormerSeg
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_uniformer

    return _strict("UniFormer", path, UniFormerSeg(device=_META),
                   ingest_uniformer)


def run_midas(path: str) -> dict:
    from fgdm_tpu_torch.annotators.midas import DPTHybrid
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_midas

    return _strict("MiDaS", path, DPTHybrid(device=_META), ingest_midas)


def run_pidinet(path: str) -> dict:
    from fgdm_tpu_torch.annotators.pidinet import PiDiNet
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_pidinet

    return _strict("PiDiNet", path, PiDiNet(device=_META), ingest_pidinet)


def run_hed(path: str) -> dict:
    from fgdm_tpu_torch.annotators.hed import ControlNetHED
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_hed

    return _lenient(path, ControlNetHED(device=_META), ingest_hed)


def run_mlsd(path: str) -> dict:
    from fgdm_tpu_torch.annotators.mlsd import MobileV2MLSDLarge
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_mlsd

    return _lenient(path, MobileV2MLSDLarge(device=_META), ingest_mlsd)


def run_openpose_body(path: str) -> dict:
    from fgdm_tpu_torch.annotators.openpose import BodyPoseNet
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_openpose

    return _lenient(path, BodyPoseNet(device=_META), ingest_openpose)


def run_openpose_hand(path: str) -> dict:
    from fgdm_tpu_torch.annotators.openpose import HandPoseNet
    from fgdm_tpu_torch.checkpoint.annotator_ingest import ingest_handpose

    return _lenient(path, HandPoseNet(device=_META), ingest_handpose)


def run_clip_vocab(path: str) -> dict:
    """``path`` is the vocab.json; merges.txt must sit beside it."""
    from fgdm_tpu_torch.models.clip import CLIPTokenizer

    tok = CLIPTokenizer(vocab_dir=os.path.dirname(path))
    if not tok.has_real_vocab:
        return _report(0, ["merges.txt"], [],
                       note="vocab.json found but tokenizer stayed on the "
                            "hash fallback (merges.txt missing/corrupt?)")
    n = len(tok.encode_text("a photograph of an astronaut riding a horse"))
    return _report(len(tok._encoder), [], [],
                   note=f"real BPE active, probe encoded to {n} ids")


def run_inception(path: str) -> dict:
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict
    from fgdm_tpu_torch.utils.inception import expected_inception_keys

    sd = load_torch_state_dict(path)
    keys = expected_inception_keys()
    missing = [k for k in keys if k not in sd]
    if missing:   # utils/inception.ingest_inception's error
        raise KeyError(f"inception ingest: {len(missing)} missing keys, "
                       f"first: {missing[:5]}")
    return _report(len(keys), [], [])


# --------------------------------------------------------------------------
# family registry: (family, file names to look for, runner)
# --------------------------------------------------------------------------

def families(geometry: str):
    return [
        ("sd-v1-4", ["sd-v1-4.ckpt", "model.ckpt"],
         lambda p: run_ldm(p, geometry, adapter_ok=True)),
        ("sd-v1-5", ["sd-v1-5.ckpt", "v1-5-pruned-emaonly.ckpt"],
         lambda p: run_ldm(p, geometry, adapter_ok=True)),
        ("fgdm-seg", ["fgdm_seg.pth"],
         lambda p: run_ldm(p, geometry, adapter_ok=False)),
        ("fgdm-depth", ["fgdm_depth.pth"],
         lambda p: run_ldm(p, geometry, adapter_ok=False)),
        ("fgdm-normal", ["fgdm_normal.pth"],
         lambda p: run_ldm(p, geometry, adapter_ok=False)),
        ("fgdm-scribble", ["fgdm_scribble.pth", "fgdm_sketch.pth"],
         lambda p: run_ldm(p, geometry, adapter_ok=False)),
        ("control-seg", ["fgdm_control_sd15_seg.pth"],
         lambda p: run_cldm(p, geometry)),
        ("control-depth", ["fgdm_control_sd15_depth.pth"],
         lambda p: run_cldm(p, geometry)),
        ("control-normal", ["fgdm_control_sd15_normal.pth"],
         lambda p: run_cldm(p, geometry)),
        ("control-scribble", ["fgdm_control_sd15_scribble.pth"],
         lambda p: run_cldm(p, geometry)),
        ("uniformer", ["upernet_global_small.pth"], run_uniformer),
        ("midas", ["dpt_hybrid-midas-501f0c75.pt"], run_midas),
        ("hed", ["ControlNetHED.pth"], run_hed),
        ("mlsd", ["mlsd_large_512_fp32.pth"], run_mlsd),
        ("openpose-body", ["body_pose_model.pth"], run_openpose_body),
        ("openpose-hand", ["hand_pose_model.pth"], run_openpose_hand),
        ("pidinet", ["table5_pidinet.pth"], run_pidinet),
        ("clip-vocab", ["vocab.json"], run_clip_vocab),
        ("inception", ["pt_inception-2015-12-21-26bd7ee1.pth",
                       "inception_v3_google-0cc3c7bd.pth"], run_inception),
    ]


def _find(weights_dir: str, names):
    for name in names:
        p = os.path.join(weights_dir, name)
        if os.path.exists(p):
            return p
    return None


def _run(runner, path) -> dict:
    # loading into a meta module warns once per key that nothing is copied
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*meta parameter.*")
        return runner(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights_dir", required=True)
    ap.add_argument("--families", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--geometry", choices=("sd", "tiny"), default="sd",
                    help="model-family defs: production SD (default) or the "
                         "test suite's tiny geometry (plumbing tests)")
    ap.add_argument("--require-all", action="store_true",
                    help="absent families fail the run too")
    ap.add_argument("--json", default="", help="also write the report here")
    args = ap.parse_args(argv)

    want = {f.strip() for f in args.families.split(",") if f.strip()}
    known = {name for name, _, _ in families(args.geometry)}
    unknown = sorted(want - known)
    if unknown:
        ap.error(f"unknown families {unknown}; known: {sorted(known)}")
    report, n_fail, n_absent, n_ok = {}, 0, 0, 0
    for name, filenames, runner in families(args.geometry):
        if want and name not in want:
            continue
        path = _find(args.weights_dir, filenames)
        if path is None:
            report[name] = {"ok": None, "absent": True}
            n_absent += 1
            print(f"[{name:<16}] absent ({filenames[0]})")
            continue
        try:
            r = _run(runner, path)
        except Exception as e:  # strict loaders raise on mismatch
            r = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc(limit=2)
        r["file"] = os.path.basename(path)
        report[name] = r
        if r["ok"]:
            n_ok += 1
            filled = (f", {r['missing']} filled from init"
                      if r.get("missing") else "")
            print(f"[{name:<16}] OK  {r['file']}: {r.get('loaded', '?')} "
                  f"arrays from file{filled}"
                  + (f" — {r['note']}" if r.get("note") else ""))
        else:
            n_fail += 1
            print(f"[{name:<16}] FAIL {r['file']}: "
                  + (r.get("error")
                     or f"{r['missing']} missing {r['missing_examples']}, "
                        f"{r['unexpected']} unexpected "
                        f"{r['unexpected_examples']}"))

    print(f"\ningest_all: {n_ok} ok, {n_fail} failed, {n_absent} absent "
          f"(geometry={args.geometry})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 1 if (n_fail or (args.require_all and n_absent)) else 0


if __name__ == "__main__":
    sys.exit(main())
