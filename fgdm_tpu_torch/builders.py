"""Full-width SD-1.4 FG-DM pipelines with seeded random weights.

``build_chain`` is the counterpart of ``bench.py:95-155``: the factor-1
``LatentDiffusion`` (SD-1.4 UNet + FG-DM adapter) and the factor-2
``ControlLDM`` (SD UNet without adapter + ControlNet), sharing one VAE; bf16
compute over float32 params, fused GroupNorm+SiLU on.  Each pipeline also
gets its own CLIP ViT-L/14 text tower, as ``checkpoint/loader.py:99-230``
builds them without checkpoints, so ``get_learned_conditioning`` works (the
serving engine embeds real tokens).  About 2.4B parameters, 9.8 GB in
float32.

``build_trainer`` is the counterpart of ``tools/bench_train.py:49-79``: the
adapter-only fine-tuning step at 256^2 (UNet with adapter, VAE and CLIP,
AdamW on the adapter partition), with a seeded synthetic batch, and the
attention-distillation step the reference config takes every
``distill_every_n_step`` steps (``fgdm_tpu/cli/train.py:282-286,383-385``).

The weights are drawn on the device from explicit generators; the UNets and
ControlNet then get the 0.02 N(0, 1) perturbation of
``tests/test_golden_chain.py:46-64`` so their zero-init heads do work (and
pass gradients to the adapter).

The config builders are the counterparts of ``fgdm_tpu/builders.py``: the
targets behind ``config.TARGET_ALIASES``, so the reference's YAML files
(``models/config.yaml``, the cldm YAMLs) instantiate unchanged.  Each
returns a ``ModuleDef`` (a module class with its arguments, built only when
asked), or a ``ModelSpec`` / ``ControlSpec`` whose ``load(ckpt_path)``
builds the pipeline through ``checkpoint/loader.py``.  ``use_checkpoint``
turns on the UNet's activation checkpointing (JAX's ``remat``; the seeded
``build_trainer`` keeps it off, as ``tools/bench_train.py`` does);
``legacy`` and the UNet's ``image_size`` are accepted and ignored;
``no_prompting`` means no adapter.  (``build_unet`` is taken by
the seeded full-width UNet above, so the UNet's config builder is
``build_unet_from_config``.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.checkpoint.loader import (SD_SCHEDULE, load_controlnet,
                                              load_fgdm, sd_clip,
                                              sd_controlnet, sd_unet, sd_vae,
                                              seeded_init_)
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.autoencoder import (AutoencoderKL,
                                               NpleAutoencoderKL)
from fgdm_tpu_torch.models.clip import CLIPTextEncoder, CLIPTokenizer
from fgdm_tpu_torch.models.controlnet import ControlNet
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.train.state import TrainState, adapter_filter, make_adamw
from fgdm_tpu_torch.train.train_step import make_train_step

__all__ = ["sd14_schedule", "build_unet", "build_chain", "Trainer",
           "build_trainer", "PROMPTS", "ModuleDef", "build_unet_from_config",
           "build_autoencoder", "build_clip", "build_controlnet", "ModelSpec",
           "build_latent_diffusion", "ControlSpec", "build_control_ldm"]

_PERTURB = 0.02


def sd14_schedule() -> DiffusionSchedule:
    return DiffusionSchedule.create(**SD_SCHEDULE)


def build_unet(device=None, dtype=torch.bfloat16, fused_norm: bool = True,
               use_adapter: bool = True, seed: int = 0) -> UNetModel:
    """A full-width SD-1.4 UNet (with or without the FG-DM adapter)."""
    unet = sd_unet(dtype, resolve_device(device), use_adapter=use_adapter,
                   fused_norm_silu=fused_norm)
    return seeded_init_(unet, seed, _PERTURB)


def build_chain(device=None, dtype=torch.bfloat16, fused_norm: bool = True,
                seed: int = 0):
    """``(LatentDiffusion, ControlLDM)`` of the FG-DM chain at SD-1.4 width,
    each with its CLIP text tower."""
    dev = resolve_device(device)
    vae = seeded_init_(sd_vae(dtype, dev, fused_norm=fused_norm), seed + 3)
    control = seeded_init_(sd_controlnet(dtype, dev,
                                         fused_norm_silu=fused_norm),
                           seed + 2, _PERTURB)
    clip, cn_clip = (seeded_init_(sd_clip(dtype, dev), s)
                     for s in (seed + 4, seed + 5))
    sched = sd14_schedule()
    ld = LatentDiffusion(build_unet(dev, dtype, fused_norm, True, seed), vae,
                         sched, clip=clip)
    cldm = ControlLDM(build_unet(dev, dtype, fused_norm, False, seed + 1), vae,
                      sched, clip=cn_clip, control=control)
    return ld, cldm


# Eight prompts of the kind the seg-factor fine-tuning data carries.
PROMPTS = [
    "a dog running on the beach", "two people riding bicycles in a park",
    "a red car parked next to a building", "a cat sleeping on a sofa",
    "a kitchen with a table and chairs", "a horse in a green field",
    "a man holding a surfboard near the ocean",
    "a bowl of fruit on a wooden table",
]


@dataclasses.dataclass
class Trainer:
    """What ``build_trainer`` returns: the pipeline, the train state over
    ``ld.unet``, the plain and the distillation step, the cadence, and a
    seeded synthetic batch for them."""

    ld: LatentDiffusion
    state: TrainState
    train_step: Callable
    batch: Dict[str, torch.Tensor]
    distill_step: Callable
    distill_every_n_step: int = 10   # models/config.yaml:25

    def step_fn(self, step: int) -> Callable:
        """The step to take at training step ``step``: the distillation
        step where ``step % distill_every_n_step == 0``, else the plain
        one (``fgdm_tpu/cli/train.py:383-385``)."""
        if step % self.distill_every_n_step == 0:
            return self.distill_step
        return self.train_step


def build_trainer(device=None, seed: int = 0, batch: int = 8,
                  lr: float = 1e-5, use_ema: bool = False,
                  dtype=torch.bfloat16) -> Trainer:
    """The adapter-only fine-tuning step of ``tools/bench_train.py`` at SD-1.4
    width: UNet with adapter (fused norms, ``dtype`` compute over f32
    params, no activation checkpointing), VAE (fused norms) and CLIP in
    ``dtype``, the linear 0.00085-0.012 schedule, AdamW(``lr``) on the
    adapter partition.  bf16 by default, as ``tools/bench_train.py``;
    ``torch.float32`` builds every model in float32, as JAX's
    ``build_latent_diffusion(dtype=jnp.float32)`` does (float32 training:
    the float32 flash forward and backward kernels).  The batch holds
    ``batch`` seeded 256^2 images in [-1, 1] and the hash-fallback tokens of
    ``PROMPTS``.  The distillation step and its cadence are the reference
    config's (``apply_distill_loss``, ``distill_every_n_step``,
    ``models/config.yaml:24-25``)."""
    dev = resolve_device(device)
    unet = build_unet(dev, dtype, True, True, seed)
    vae = seeded_init_(sd_vae(dtype, dev), seed + 3).requires_grad_(False)
    clip = seeded_init_(sd_clip(dtype, dev), seed + 4).requires_grad_(False)
    ld = LatentDiffusion(unet, vae, sd14_schedule().to(dev), clip=clip)
    state = TrainState.create(unet, make_adamw(lr),
                              trainable_filter=adapter_filter(),
                              use_ema=use_ema)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    image = torch.randn(batch, 3, 256, 256, device=dev,
                        generator=gen).clamp_(-1.0, 1.0)
    ids = CLIPTokenizer()([PROMPTS[i % len(PROMPTS)] for i in range(batch)])
    return Trainer(ld, state, make_train_step(ld),
                   {"image": image, "input_ids": ids.to(dev)},
                   make_train_step(ld, distill=True))


# --- config builders (``fgdm_tpu/builders.py:25-310``) -----------------------

@dataclasses.dataclass(frozen=True)
class ModuleDef:
    """A module class and its constructor arguments, as a parsed config
    names them; ``build`` makes the module on a device (CUDA unless
    named)."""

    cls: type
    kwargs: Dict[str, Any]

    def build(self, device=None) -> nn.Module:
        return self.cls(device=resolve_device(device), **self.kwargs)

    def clone(self, **overrides) -> "ModuleDef":
        """The same definition with ``overrides`` replacing arguments (flax's
        ``Module.clone``; the CLI's ``num_prompts`` per chain factor)."""
        return ModuleDef(self.cls, {**self.kwargs, **overrides})


def build_unet_from_config(dtype=torch.bfloat16, **p) -> ModuleDef:
    return ModuleDef(UNetModel, dict(
        in_channels=p.get("in_channels", 4),
        model_channels=p.get("model_channels", 320),
        out_channels=p.get("out_channels", 4),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=p.get("num_heads", 8),
        num_head_channels=p.get("num_head_channels", -1),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim"),
        use_spatial_transformer=p.get("use_spatial_transformer", True),
        use_new_attention_order=p.get("use_new_attention_order", False),
        use_scale_shift_norm=p.get("use_scale_shift_norm", False),
        resblock_updown=p.get("resblock_updown", False),
        num_classes=p.get("num_classes"),
        use_adapter=not p.get("no_prompting", False),
        adapter_channels=p.get("adapter_channels"),
        use_time_adapter=p.get("use_time_adapter", False),
        # the fused GroupNorm+SiLU (K4): the production configuration
        fused_norm_silu=p.get("fused_norm_silu", True),
        # activation checkpointing
        remat=p.get("use_checkpoint", False),
        dtype=dtype))


def build_autoencoder(dtype=torch.bfloat16, nple: Optional[int] = None, **p
                      ) -> ModuleDef:
    """``AutoencoderKL``, or ``NpleAutoencoderKL`` when ``nple`` is set."""
    dd = p.get("ddconfig", {})
    extra = {"nple": nple} if nple else {}
    return ModuleDef(NpleAutoencoderKL if nple else AutoencoderKL, dict(
        embed_dim=p.get("embed_dim", 4),
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=tuple(dd.get("attn_resolutions", ()) or ()),
        in_channels=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        resolution=dd.get("resolution", 256),
        z_channels=dd.get("z_channels", 4),
        double_z=dd.get("double_z", True),
        fused_norm=p.get("fused_norm", True),
        dtype=dtype, **extra))


def build_clip(dtype=torch.bfloat16, **p) -> ModuleDef:
    return ModuleDef(CLIPTextEncoder, dict(
        max_length=p.get("max_length", 77), dtype=dtype))


def build_controlnet(dtype=torch.bfloat16, **p) -> ModuleDef:
    """ControlNet from a ``control_stage_config`` params block."""
    return ModuleDef(ControlNet, dict(
        in_channels=p.get("in_channels", 4),
        model_channels=p.get("model_channels", 320),
        hint_channels=p.get("hint_channels", 3),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=p.get("num_heads", 8),
        num_head_channels=p.get("num_head_channels", -1),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim"),
        use_scale_shift_norm=p.get("use_scale_shift_norm", False),
        fused_norm_silu=p.get("fused_norm_silu", True),
        dtype=dtype))


def _schedule_args(p) -> Dict[str, Any]:
    return dict(timesteps=p.get("timesteps", 1000),
                beta_schedule=p.get("beta_schedule", "linear"),
                linear_start=p.get("linear_start", 1e-4),
                linear_end=p.get("linear_end", 2e-2),
                cosine_s=p.get("cosine_s", 8e-3),
                v_posterior=p.get("v_posterior", 0.0),
                parameterization=p.get("parameterization", "eps"))


def _clip_def(dtype, p) -> Optional[ModuleDef]:
    cond_cfg = p.get("cond_stage_config", "__is_unconditional__")
    if isinstance(cond_cfg, dict):
        return build_clip(dtype=dtype, **(cond_cfg.get("params") or {}))
    if cond_cfg in ("__is_unconditional__", None):
        return None
    return build_clip(dtype=dtype)


def _params(p, key) -> Dict[str, Any]:
    return p.get(key, {}).get("params") or {}


@dataclasses.dataclass
class ModelSpec:
    """A parsed LatentDiffusion config: module definitions and the training
    knobs of JAX's ``ModelSpec`` (``fgdm_tpu/builders.py:84-113``), with
    ``raw`` the params block as parsed; ``load`` builds the pipeline."""

    unet_def: ModuleDef
    vae_def: ModuleDef
    clip_def: Optional[ModuleDef]
    schedule_args: Dict[str, Any]
    conditioning_key: str = "crossattn"
    scale_factor: float = 0.18215
    image_size: int = 32
    base_learning_rate: float = 1e-5
    use_ema: bool = False
    freeze_backbone: bool = False
    apply_distill_loss: bool = False
    distill_every_n_step: int = 10
    monitor: str = "val/loss_simple_ema"
    ckpt_path: Optional[str] = None
    scheduler_config: Optional[Dict[str, Any]] = None
    parameterization: str = "eps"
    # the condition-synthesis flags (reference ddpm.py:137-150)
    use_depth: bool = False
    use_normal: bool = False
    use_sketch: bool = False
    use_hed: bool = False
    sketch_to_normal: bool = False
    img_factor_train: bool = False
    scale_by_std: bool = False
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule.create(**self.schedule_args)

    def condition_kind(self) -> Optional[str]:
        """The condition-synthesis kind of the config's flags
        (``train/condition.py condition_kind``); None for a seg config."""
        from fgdm_tpu_torch.train.condition import condition_kind

        return condition_kind(
            use_depth=self.use_depth, use_normal=self.use_normal,
            use_sketch=self.use_sketch, use_hed=self.use_hed,
            sketch_to_normal=self.sketch_to_normal)

    def load(self, ckpt_path: Optional[str] = None, device=None
             ) -> LatentDiffusion:
        """The pipeline with this config's modules, schedule, scale factor
        and conditioning key (not SD-1.x's defaults), from ``ckpt_path``
        (or the config's own) when given."""
        dev = resolve_device(device)
        return load_fgdm(
            ckpt_path or self.ckpt_path, unet=self.unet_def.build(dev),
            vae=self.vae_def.build(dev),
            clip=self.clip_def.build(dev) if self.clip_def else None,
            schedule=self.schedule(), scale_factor=self.scale_factor,
            conditioning_key=self.conditioning_key, device=dev)


def build_latent_diffusion(dtype=torch.bfloat16, **p) -> ModelSpec:
    return ModelSpec(
        unet_def=build_unet_from_config(dtype=dtype,
                                        **_params(p, "unet_config")),
        vae_def=build_autoencoder(dtype=dtype,
                                  **_params(p, "first_stage_config")),
        clip_def=_clip_def(dtype, p),
        schedule_args=_schedule_args(p),
        conditioning_key=p.get("conditioning_key", "crossattn"),
        scale_factor=p.get("scale_factor", 1.0),
        image_size=p.get("image_size", 32),
        base_learning_rate=p.get("base_learning_rate", 1e-5),
        use_ema=p.get("use_ema", True),
        freeze_backbone=p.get("freeze_backbone", False),
        apply_distill_loss=p.get("apply_distill_loss", False),
        distill_every_n_step=p.get("distill_every_n_step", 10),
        monitor=p.get("monitor", "val/loss_simple_ema"),
        ckpt_path=p.get("ckpt_path"),
        scheduler_config=p.get("scheduler_config"),
        parameterization=p.get("parameterization", "eps"),
        use_depth=p.get("use_depth", False),
        use_normal=p.get("use_normal", False),
        use_sketch=p.get("use_sketch", False),
        use_hed=p.get("use_hed", False),
        sketch_to_normal=p.get("sketch_to_normal", False),
        img_factor_train=p.get("img_factor_train", False),
        scale_by_std=p.get("scale_by_std", False),
        raw=p)


@dataclasses.dataclass
class ControlSpec:
    """A parsed ControlLDM config (``cldm.cldm.ControlLDM``)."""

    unet_def: ModuleDef
    cn_def: ModuleDef
    vae_def: ModuleDef
    clip_def: Optional[ModuleDef]
    schedule_args: Dict[str, Any]
    scale_factor: float = 0.18215
    only_mid_control: bool = False
    ckpt_path: Optional[str] = None
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule.create(**self.schedule_args)

    def load(self, ckpt_path: Optional[str] = None, device=None
             ) -> ControlLDM:
        dev = resolve_device(device)
        cldm = load_controlnet(
            ckpt_path or self.ckpt_path, unet=self.unet_def.build(dev),
            cn=self.cn_def.build(dev), vae=self.vae_def.build(dev),
            clip=self.clip_def.build(dev) if self.clip_def else None,
            schedule=self.schedule(), scale_factor=self.scale_factor,
            device=dev)
        cldm.only_mid_control = self.only_mid_control
        return cldm


def build_control_ldm(dtype=torch.bfloat16, **p) -> ControlSpec:
    unet_p = {k: v for k, v in _params(p, "unet_config").items()
              if k != "no_prompting"}
    return ControlSpec(
        unet_def=build_unet_from_config(dtype=dtype, no_prompting=True,
                                        **unet_p),
        cn_def=build_controlnet(dtype=dtype,
                                **_params(p, "control_stage_config")),
        vae_def=build_autoencoder(dtype=dtype,
                                  **_params(p, "first_stage_config")),
        clip_def=_clip_def(dtype, p),
        schedule_args=_schedule_args(p),
        scale_factor=p.get("scale_factor", 0.18215),
        only_mid_control=p.get("only_mid_control", False),
        ckpt_path=p.get("ckpt_path"),
        raw=p)
