"""The FG-DM pipelines from reference checkpoints.

Counterpart of ``fgdm_tpu/checkpoint/loader.py``: ``load_fgdm`` assembles
the condition factor (UNet with the FG-DM adapter, VAE, CLIP) the way the
reference's ``load_model_from_config`` does (build from config, load
``fgdm_seg.pth`` with ``strict=False``), and ``load_controlnet`` the
seg -> image stage (SD UNet without adapter, ControlNet, VAE, CLIP) from a
``fgdm_control_sd15_*.pth``.

Every module is built on its device and first takes its seeded init, drawn
from an explicit ``torch.Generator`` (``init_params_``: the JAX package's
variance-scaling init, zero-init heads kept at zero); the checkpoint then
overwrites what it holds.  So keys absent from the file keep a real init,
not zeros (``_fill_missing_from_init`` of ``loader.py:77-96``), and with no
path the whole model is that init.  Tensors are read on the CPU
(memory-mapped) and copied into the device's parameters one by one.

The presets are SD-1.x's, with the fused GroupNorm+SiLU on (as ``bench.py``
and the config builders build them; on the CPU it is the plain GroupNorm
then SiLU).  Each pipeline carries ``load_report``: the path, the missing
keys of each part and the unexpected ones.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.checkpoint import torch_ingest as ti
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.clip import CLIPTextEncoder
from fgdm_tpu_torch.models.controlnet import ControlNet
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.nn.layers import init_params_

__all__ = ["SD_SCHEDULE", "sd_unet", "sd_vae", "sd_clip", "sd_controlnet",
           "seeded_init_", "load_fgdm", "load_controlnet"]

SD_SCHEDULE = dict(timesteps=1000, beta_schedule="linear",
                   linear_start=0.00085, linear_end=0.0120)


def sd_unet(dtype=torch.bfloat16, device=None, **overrides) -> UNetModel:
    """SD-1.4 UNet (``models/config.yaml:33-48``), with the adapter unless
    ``use_adapter=False``."""
    cfg = dict(in_channels=4, out_channels=4, model_channels=320,
               num_res_blocks=2, attention_resolutions=(4, 2, 1),
               channel_mult=(1, 2, 4, 4), num_heads=8, transformer_depth=1,
               context_dim=768, fused_norm_silu=True)
    cfg.update(overrides)
    return UNetModel(dtype=dtype, device=device, **cfg)


def sd_vae(dtype=torch.bfloat16, device=None, **overrides) -> AutoencoderKL:
    cfg = dict(embed_dim=4, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
               attn_resolutions=(), z_channels=4, resolution=256,
               fused_norm=True)
    cfg.update(overrides)
    return AutoencoderKL(dtype=dtype, device=device, **cfg)


def sd_clip(dtype=torch.bfloat16, device=None) -> CLIPTextEncoder:
    return CLIPTextEncoder(dtype=dtype, device=device)


def sd_controlnet(dtype=torch.bfloat16, device=None, **overrides
                  ) -> ControlNet:
    cfg = dict(in_channels=4, model_channels=320, hint_channels=3,
               num_res_blocks=2, attention_resolutions=(4, 2, 1),
               channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768,
               fused_norm_silu=True)
    cfg.update(overrides)
    return ControlNet(dtype=dtype, device=device, **cfg)


def seeded_init_(module: nn.Module, seed: int, perturb: float = 0.0
                 ) -> nn.Module:
    """Every weight of ``module`` drawn anew from a generator seeded with
    ``seed`` on the module's device (plus ``perturb`` * N(0, 1), see
    ``init_params_``); returns it in eval mode."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params_(module, gen, perturb).eval()


def _ingest(sd, parts, path, label, verbose):
    """Load each ``(name, ingest, module)`` of ``parts`` from ``sd``;
    the report of ``load_report``."""
    missing, unexpected = {}, []
    for name, ingest, module in parts:
        m, u = ingest(sd, module)
        missing[name] = m
        unexpected += u
    if verbose:
        print(f"[{label}] {path}: missing "
              + " ".join(f"{k}={len(v)}" for k, v in missing.items())
              + f" unexpected={len(unexpected)}")
        for name, keys in missing.items():
            if keys:
                heads = sorted({".".join(k.split(".")[:3]) for k in keys})
                print(f"[load] {name}: {len(keys)} params kept at module "
                      f"init (subtrees: {heads[:6]}"
                      f"{'...' if len(heads) > 6 else ''})")
    return {"path": path, "missing": missing, "unexpected": unexpected}


def load_fgdm(ckpt_path: Optional[str] = None, dtype=torch.bfloat16,
              use_time_adapter: bool = False,
              ignore_keys: Sequence[str] = ("model_ema.",),
              verbose: bool = True, unet: Optional[UNetModel] = None,
              vae: Optional[AutoencoderKL] = None,
              clip: Optional[CLIPTextEncoder] = None,
              schedule: Optional[DiffusionSchedule] = None,
              scale_factor: float = 0.18215,
              conditioning_key: str = "crossattn",
              device=None) -> LatentDiffusion:
    """The condition-factor pipeline (UNet + adapter, VAE, CLIP), from
    ``ckpt_path`` when given.  Module definitions, schedule, scale factor
    and conditioning key (any key JAX's router takes,
    ``latent_diffusion.CONDITIONING_KEYS``) default to SD-1.x (with a ``TimeAdapter`` when
    ``use_time_adapter``); a parsed config passes its own
    (``builders.ModelSpec.load``).  A UNet with ``num_prompts > 1`` loads
    as any other: its extra adapters keep the seeded init and are counted
    as missing (``torch_ingest.ingest_unet``).  Modules the caller passes
    keep their device; the rest are built on ``device`` (CUDA unless
    named)."""
    dev = resolve_device(device)
    unet = (unet if unet is not None
            else sd_unet(dtype, dev, use_time_adapter=use_time_adapter))
    vae = vae if vae is not None else sd_vae(dtype, dev)
    clip = clip if clip is not None else sd_clip(dtype, dev)
    for seed, module in enumerate((unet, vae, clip)):
        seeded_init_(module, seed)
    report = None
    if ckpt_path:
        sd = ti.apply_key_surgery(ti.load_torch_state_dict(ckpt_path),
                                  ignore_keys=ignore_keys)
        report = _ingest(sd, (("unet", ti.ingest_unet, unet),
                              ("vae", ti.ingest_vae, vae),
                              ("clip", ti.ingest_clip, clip)),
                         ckpt_path, "load_fgdm", verbose)
    return LatentDiffusion(
        unet, vae, schedule or DiffusionSchedule.create(**SD_SCHEDULE),
        scale_factor=scale_factor, clip=clip, load_report=report,
        conditioning_key=conditioning_key)


def load_controlnet(ckpt_path: Optional[str] = None, dtype=torch.bfloat16,
                    share_first_stage: Optional[LatentDiffusion] = None,
                    verbose: bool = True, unet: Optional[UNetModel] = None,
                    cn: Optional[ControlNet] = None,
                    vae: Optional[AutoencoderKL] = None,
                    clip: Optional[CLIPTextEncoder] = None,
                    schedule: Optional[DiffusionSchedule] = None,
                    scale_factor: float = 0.18215,
                    device=None) -> ControlLDM:
    """The seg -> image pipeline (SD UNet without adapter + ControlNet).

    With ``share_first_stage`` the pipeline takes that pipeline's VAE and
    CLIP objects (no second copy; the file's VAE and CLIP keys are not
    read) and builds on its device."""
    if share_first_stage is not None:
        vae, clip = share_first_stage.vae, share_first_stage.clip
        dev = next(vae.parameters()).device
    else:
        dev = resolve_device(device)
    unet = unet if unet is not None else sd_unet(dtype, dev, use_adapter=False)
    cn = cn if cn is not None else sd_controlnet(dtype, dev)
    parts = [("unet", ti.ingest_unet, seeded_init_(unet, 0)),
             ("control", ti.ingest_controlnet, seeded_init_(cn, 3))]
    if share_first_stage is None:
        vae = seeded_init_(vae if vae is not None else sd_vae(dtype, dev), 1)
        clip = seeded_init_(clip if clip is not None else sd_clip(dtype, dev),
                            2)
        parts += [("vae", ti.ingest_vae, vae), ("clip", ti.ingest_clip, clip)]
    report = None
    if ckpt_path:
        report = _ingest(ti.load_torch_state_dict(ckpt_path), parts,
                         ckpt_path, "load_controlnet", verbose)
    return ControlLDM(
        unet, vae, schedule or DiffusionSchedule.create(**SD_SCHEDULE),
        scale_factor=scale_factor, clip=clip, load_report=report, control=cn)
