"""Metrics, image logging and the model's diagnostic images.

Counterpart of ``fgdm_tpu/train/metrics.py`` (the reference's TestTube
logger and ``ImageLogger`` callback, ``main.py:313-417,566-590``, and
``log_images``, ``ddpm.py:1466-1599``):

* ``MetricsWriter``: one JSON row a call (step, seconds since the writer
  opened, prefixed scalars) appended to ``<logdir>/metrics.jsonl``.
* ``ImageLogger``: every ``batch_frequency`` steps, one PNG grid a key,
  ``<logdir>/images/<key>_gs-<step:06>.png``.
* ``to_uint8``/``make_grid`` (also the inference CLI's grids),
  ``denoise_row_grid`` (all frames of a row grid in one batched decode) and
  ``log_txt_as_img``.
* ``log_images``: the diagnostics dict, with JAX's keys and flags.  Images
  leave it as NHWC numpy in [-1, 1] (the row keys as uint8 grids), as in
  JAX.  Its random draws may be injected (``draws``), so the tests can feed
  JAX's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.sampling.ddim import ddim_sample

__all__ = ["MetricsWriter", "to_uint8", "make_grid", "denoise_row_grid",
           "ImageLogger", "log_txt_as_img", "log_images"]


class MetricsWriter:
    """Append-only JSONL of scalar rows; ``close`` closes the file."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = ""):
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[f"{prefix}/{k}" if prefix else k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return (np.clip((np.asarray(img) + 1.0) / 2.0, 0, 1) * 255).astype(
        np.uint8)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """``[N, H, W, C]`` uint8 -> one grid image, ``nrow`` images a row on a
    white ground."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    rows = (n + nrow - 1) // nrow
    grid = np.full((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), 255,
                   np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = img
    return grid


def _nhwc(x) -> np.ndarray:
    """An NCHW tensor (or NHWC array) -> NHWC float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.cpu().numpy()
    return np.asarray(x)


def denoise_row_grid(x_inter, decode_fn: Optional[Callable] = None
                     ) -> np.ndarray:
    """``[S, B, ...]`` frames -> one grid row per sample, S frames a row.

    With ``decode_fn`` the frames are NCHW latents, all S * B decoded in one
    batched call; without, they are NHWC images in [-1, 1]."""
    S, B = x_inter.shape[:2]
    if decode_fn is not None:
        flat = _nhwc(decode_fn(x_inter.reshape((S * B,)
                                               + tuple(x_inter.shape[2:]))))
        frames = flat.reshape((S, B) + flat.shape[1:])
    else:
        frames = _nhwc(x_inter)
    imgs = [to_uint8(frames[s, b]) for b in range(B) for s in range(S)]
    return make_grid(np.stack(imgs), nrow=S)


class ImageLogger:
    """Every ``batch_frequency`` steps, a PNG grid of each diagnostics key
    (reference ``ImageLogger``, ``main.py:313-417``)."""

    def __init__(self, logdir: str, batch_frequency: int = 800,
                 max_images: int = 8):
        self.dir = os.path.join(logdir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self.freq = batch_frequency
        self.max_images = max_images

    def should_log(self, step: int) -> bool:
        return step % self.freq == 0

    def log(self, step: int, images: Dict[str, np.ndarray]):
        from PIL import Image

        for key, arr in images.items():
            arr = np.asarray(arr)
            if arr.ndim == 3:  # the *_row keys come as a finished grid
                grid = arr if arr.dtype == np.uint8 else to_uint8(arr)
            else:
                arr = arr[: self.max_images]
                grid = make_grid(arr if arr.dtype == np.uint8
                                 else to_uint8(arr))
            Image.fromarray(grid.squeeze() if grid.shape[-1] == 1
                            else grid).save(
                os.path.join(self.dir, f"{key}_gs-{step:06}.png"))


def log_txt_as_img(wh, captions: Iterable[str]) -> np.ndarray:
    """Captions drawn on white ``wh`` tiles (reference ``log_txt_as_img``,
    ``ldm/util.py:22-41``) -> ``[B, H, W, 3]`` float32 in [-1, 1]."""
    from PIL import Image, ImageDraw

    w, h = wh
    tiles = []
    for cap in captions:
        img = Image.new("RGB", (w, h), "white")
        nc = max(int(10 * (w / 256)), 1)
        cap = str(cap)
        ImageDraw.Draw(img).text(
            (0, 0), "\n".join(cap[i:i + nc] for i in range(0, len(cap), nc)),
            fill="black")
        tiles.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(tiles)


def _draw(draws, key, shape, generator, device) -> torch.Tensor:
    if key in draws:
        return draws[key].to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def log_images(ld, batch: Dict[str, Any],
               generator: Optional[torch.Generator] = None, n: int = 4,
               ddim_steps: int = 50, cfg_scale: float = 7.5,
               sample: bool = True, inpaint: bool = False,
               plot_denoise_rows: bool = False,
               plot_progressive_rows: bool = False,
               plot_diffusion_rows: bool = False, n_diffusion_steps: int = 8,
               params: Optional[Dict[str, torch.Tensor]] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, np.ndarray]:
    """The diagnostics of the first ``n`` samples of ``batch`` (``image``
    NCHW on the model's device, ``input_ids``, ``captions``).

    Always ``inputs`` and ``reconstruction`` (the posterior mode decoded),
    and ``conditioning`` (the captions as tiles) when the batch has them.
    With the flags, as JAX's:

    * ``plot_diffusion_rows``: ``diffusion_row``, ``q_sample`` at
      ``n_diffusion_steps`` even timesteps of one noise draw;
    * ``sample``: ``samples``, DDIM at CFG ``cfg_scale`` with the empty
      prompt's context as the uncondition; ``plot_denoise_rows`` and
      ``plot_progressive_rows`` add ``denoise_row`` and ``progressive_row``
      from x and x0-hat every ``max(ddim_steps // 8, 1)`` steps;
    * ``inpaint``: ``samples_inpainting`` with the latent's centre square
      resampled, ``mask``, and ``samples_outpainting`` with the mask
      inverted (the reference reuses the inpainting mask there,
      ``ddpm.py:1583-1588``; JAX inverts it).

    ``params`` (the EMA shadow, name -> tensor of ``ld.unet``) replace the
    UNet's parameters while sampling and are put back after.  ``draws``
    injects the noise: ``diffusion_noise`` (the latent's shape),
    ``x_T``, ``inpaint_x_T``, ``outpaint_x_T`` and
    ``inpaint_mask_noise``/``outpaint_mask_noise`` (``[ddim_steps,
    *shape]``); the rest is drawn from ``generator``, in that order."""
    draws = draws or {}
    live = dict(ld.unet.named_parameters())
    saved = {}
    with torch.no_grad():
        for k, v in (params or {}).items():
            saved[k] = live[k].detach().clone()
            live[k].copy_(v)
    try:
        with torch.inference_mode():
            return _log_images(
                ld, batch, generator, n, ddim_steps, cfg_scale, sample,
                inpaint, plot_denoise_rows, plot_progressive_rows,
                plot_diffusion_rows, n_diffusion_steps, draws)
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                live[k].copy_(v)


def _log_images(ld, batch, generator, n, ddim_steps, cfg_scale, sample,
                inpaint, plot_denoise_rows, plot_progressive_rows,
                plot_diffusion_rows, n_diffusion_steps, draws):
    out: Dict[str, np.ndarray] = {}
    img = batch["image"][:n]
    dev = img.device
    out["inputs"] = _nhwc(img)
    z = ld.encode_first_stage(img)
    out["reconstruction"] = _nhwc(ld.decode_first_stage(z))
    caps = batch.get("captions")
    if caps is None:
        caps = batch.get("caption")
    if caps is not None:
        out["conditioning"] = log_txt_as_img((img.shape[3], img.shape[2]),
                                             list(caps)[:n])

    if plot_diffusion_rows:
        T = int(ld.schedule.num_timesteps)
        ts = np.linspace(0, T - 1, n_diffusion_steps).astype(np.int32)
        noise = _draw(draws, "diffusion_noise", z.shape, generator, dev)
        sched = ld.schedule.to(dev)
        noised = torch.stack([
            sched.q_sample(z, torch.full((z.shape[0],), int(t),
                                         dtype=torch.int64, device=dev),
                           noise) for t in ts])
        out["diffusion_row"] = denoise_row_grid(
            noised, decode_fn=ld.decode_first_stage)

    if "input_ids" not in batch:
        return out
    ids = batch["input_ids"][:n]
    cond = {"c_crossattn": ld.get_learned_conditioning(ids)}
    uncond = {"c_crossattn": ld.get_learned_conditioning(
        torch.zeros_like(ids))}
    sched = DDIMSchedule.create(ld.schedule, ddim_steps)

    def run(x_T, **kw):
        return ddim_sample(ld.denoise_fn(), tuple(z.shape), sched, cond,
                           uncond, cfg_scale, x_T=x_T, generator=generator,
                           device=dev, **kw)

    if sample:
        rows = plot_denoise_rows or plot_progressive_rows
        res = run(_draw(draws, "x_T", z.shape, generator, dev),
                  log_every_t=max(ddim_steps // 8, 1) if rows else 0)
        zs, inter = res if rows else (res, None)
        out["samples"] = _nhwc(ld.decode_first_stage(zs))
        if plot_denoise_rows:
            out["denoise_row"] = denoise_row_grid(
                inter["x_inter"], decode_fn=ld.decode_first_stage)
        if plot_progressive_rows:
            out["progressive_row"] = denoise_row_grid(
                inter["pred_x0"], decode_fn=ld.decode_first_stage)

    if inpaint:
        # the latent's centre square resampled; mask = 1 marks kept regions
        b, h, w = z.shape[0], z.shape[2], z.shape[3]
        mask = torch.ones(b, 1, h, w, device=dev)
        mask[:, :, h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 0.0
        for key, m in (("inpaint", mask), ("outpaint", 1.0 - mask)):
            x_T = _draw(draws, f"{key}_x_T", z.shape, generator, dev)
            mask_noise = draws.get(f"{key}_mask_noise")
            zp = run(x_T, mask=m, x0=z, schedule=ld.schedule,
                     mask_noise=mask_noise)
            out[f"samples_{key}ing"] = _nhwc(ld.decode_first_stage(zp))
            if key == "inpaint":
                out["mask"] = _nhwc(mask) * 2.0 - 1.0  # to_uint8 reads [-1, 1]
    return out
