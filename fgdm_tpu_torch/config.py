"""Config system: YAML with ``target:``/``params:`` instantiation.

Counterpart of ``fgdm_tpu/config.py``: the reference's OmegaConf-based
``instantiate_from_config`` (``ldm/util.py:78-93``), left-to-right config
merging and ``nested.key=value`` overrides (``main.py:539-541``), without
omegaconf, and ``TARGET_ALIASES``, which resolves the reference's target
strings to the port's builders, so the reference's own YAML files
(``models/config.yaml``, ``configs/stable-diffusion/*.yaml``,
``controlnet/models/cldm_v15_*.yaml``) instantiate unchanged.

PyYAML is imported when a YAML is read, not when this module is.  The
training targets resolve as in ``fgdm_tpu/config.py:141-206``: the dataset
to ``data.dataset.load_data``, the Lightning data module to its params dict
and the image logger to a ``logdir -> train.metrics.ImageLogger`` factory.
"""

from __future__ import annotations

import copy
import functools
import importlib
import re
from typing import Any, Callable, Dict, Sequence

__all__ = ["load_config", "merge_configs", "apply_dot_overrides",
           "instantiate_from_config", "get_obj_from_str", "TARGET_ALIASES"]

# PyYAML's YAML-1.1 float pattern demands a dot before an exponent, so
# ``5e-5`` would read as a string; OmegaConf, the reference's config layer,
# reads it as a float, and so does this resolver (``config.py:32-51``).
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


@functools.lru_cache(maxsize=None)
def _loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT,
                                 list("-+0123456789."))
    return Loader


def _yaml_load(text_or_stream) -> Any:
    import yaml

    return yaml.load(text_or_stream, Loader=_loader())


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return _yaml_load(f) or {}


def merge_configs(*configs: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge, rightmost wins."""
    out: Dict[str, Any] = {}
    for cfg in configs:
        out = _deep_merge(out, cfg)
    return out


def _deep_merge(a: Any, b: Any) -> Any:
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _deep_merge(a[k], v) if k in a else copy.deepcopy(v)
        return out
    return copy.deepcopy(b)


def apply_dot_overrides(cfg: Dict[str, Any], dotlist: Sequence[str]
                        ) -> Dict[str, Any]:
    """``nested.key=value`` overrides, each value read as YAML."""
    cfg = copy.deepcopy(cfg)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _yaml_load(raw)
    return cfg


# -- reference target names -> the port's builders ---------------------------

def _builder(name: str) -> Callable[..., Any]:
    """``builders.<name>``, looked up when the target is built."""

    def build(**params):
        from fgdm_tpu_torch import builders

        return getattr(builders, name)(**params)

    return build


def _build_controlled_unet(**params):
    from fgdm_tpu_torch import builders

    params.pop("no_prompting", None)
    return builders.build_unet_from_config(no_prompting=True, **params)


def _build_lambda_linear(**params):
    from fgdm_tpu_torch.train.lr_schedules import lambda_linear

    p = {k: (v[0] if isinstance(v, list) else v) for k, v in params.items()}
    return lambda_linear(warm_up_steps=p.get("warm_up_steps", 10000),
                         f_start=p.get("f_start", 1e-5),
                         f_max=p.get("f_max", 1.0), f_min=p.get("f_min", 1.0),
                         cycle_length=p.get("cycle_lengths", 1e13))


def _identity(**params):
    return lambda x: x


def _build_load_data(**params):
    from fgdm_tpu_torch.data.dataset import load_data

    return load_data(**params)


def _data_module(**params):
    """``main.DataModuleFromConfig``: the parsed data spec; the training CLI
    builds its loaders from it."""
    return dict(params)


def _image_logger(**params):
    """``main.ImageLogger``: a ``logdir -> ImageLogger`` factory."""
    from fgdm_tpu_torch.train.metrics import ImageLogger

    return lambda logdir: ImageLogger(
        logdir, batch_frequency=params.get("batch_frequency", 800),
        max_images=params.get("max_images", 8))


TARGET_ALIASES: Dict[str, Callable[..., Any]] = {
    "ldm.models.diffusion.ddpm.LatentDiffusion":
        _builder("build_latent_diffusion"),
    "ldm.models.diffusion.ddpm.AdaptDiffusion":
        _builder("build_latent_diffusion"),
    "ldm.modules.diffusionmodules.openaimodel.UNetModel":
        _builder("build_unet_from_config"),
    "ldm.modules.diffusionmodules.openaimodel.AdaptUNetModel":
        _builder("build_unet_from_config"),
    "controlnet.cldm.cldm.ControlLDM": _builder("build_control_ldm"),
    "cldm.cldm.ControlLDM": _builder("build_control_ldm"),
    "controlnet.cldm.cldm.ControlNet": _builder("build_controlnet"),
    "cldm.cldm.ControlNet": _builder("build_controlnet"),
    "controlnet.cldm.cldm.ControlledUnetModel": _build_controlled_unet,
    "cldm.cldm.ControlledUnetModel": _build_controlled_unet,
    "ldm.models.autoencoder.AutoencoderKL": _builder("build_autoencoder"),
    "ldm.models.autoencoder.NpleAutoencoderKL":
        _builder("build_autoencoder"),
    "ldm.modules.encoders.modules.FrozenCLIPEmbedder": _builder("build_clip"),
    "ldm.data.semantic.load_data": _build_load_data,
    "ldm.lr_scheduler.LambdaLinearScheduler": _build_lambda_linear,
    "torch.nn.Identity": _identity,
    "main.DataModuleFromConfig": _data_module,
    "main.ImageLogger": _image_logger,
    # the port's own dotted names resolve by import
}


def get_obj_from_str(string: str) -> Callable[..., Any]:
    if string in TARGET_ALIASES:
        return TARGET_ALIASES[string]
    module, _, cls = string.rpartition(".")
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: Dict[str, Any], **extra) -> Any:
    """``{target: dotted.path, params: {...}}`` -> object; the reference's
    ``__is_first_stage__``/``__is_unconditional__`` markers give None."""
    if not isinstance(config, dict) or "target" not in config:
        if config in ("__is_first_stage__", "__is_unconditional__"):
            return None
        raise KeyError(f"expected a config dict with 'target', got {config!r}")
    params = dict(config.get("params") or {})
    params.update(extra)
    return get_obj_from_str(config["target"])(**params)
