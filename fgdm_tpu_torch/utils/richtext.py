"""Rich-text prompt parsing, on the host.

Counterpart of ``fgdm_tpu/utils/richtext.py`` (the reference's
``utils/richtext_utils.py:7-136``): a rich-text editor emits Quill-delta JSON
(``ops`` spans with font, color, size and link attributes); ``parse_json``
turns it into region prompts: fonts into art-style suffixes, colors into
gradient-guidance targets (the nearest named color), links into footnote
prompts, sizes into token reweighting weights.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

__all__ = ["COLORS", "FONT_STYLES", "hex_to_rgb", "find_nearest_color",
           "font2style", "parse_json"]

COLORS: Dict[str, List[int]] = {
    "brown": [165, 42, 42], "red": [255, 0, 0], "pink": [253, 108, 158],
    "orange": [255, 165, 0], "yellow": [255, 255, 0], "purple": [128, 0, 128],
    "green": [0, 128, 0], "blue": [0, 0, 255], "white": [255, 255, 255],
    "gray": [128, 128, 128], "black": [0, 0, 0],
}

FONT_STYLES: Dict[str, str] = {
    "mirza": "Claud Monet, impressionism, oil on canvas",
    "roboto": "Ukiyoe",
    "cursive": "Cyber Punk, futuristic, blade runner, william gibson, "
               "trending on artstation hq",
    "sofia": "Pop Art, masterpiece, andy warhol",
    "slabo": "Vincent Van Gogh",
    "inconsolata": "Pixel Art, 8 bits, 16 bits",
    "ubuntu": "Rembrandt",
    "Monoton": "neon art, colorful light, highly details, octane render",
    "Akronim": "Abstract Cubism, Pablo Picasso",
}


def hex_to_rgb(hex_string: str) -> np.ndarray:
    """``"#rrggbb"`` -> float32 RGB in [0, 1]."""
    h = hex_string.lstrip("#")
    return np.asarray([int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)],
                      np.float32) / 255.0


def find_nearest_color(rgb) -> str:
    """The name in ``COLORS`` nearest to ``rgb`` (in [0, 1], or 0-255)."""
    rgb = np.asarray(rgb, np.float32)
    if rgb.max() > 1:
        rgb = rgb / 255.0
    names = list(COLORS)
    dists = [np.linalg.norm(rgb - np.asarray(COLORS[n], np.float32) / 255.0)
             for n in names]
    return names[int(np.argmin(dists))]


def font2style(font: str) -> str:
    return FONT_STYLES[font]


def parse_json(payload: Dict[str, Any]):
    """Quill-delta JSON -> ``(base_prompt, style_prompts, footnote_prompts,
    footnote_targets, color_prompts, color_names, color_rgbs,
    size_prompts_and_sizes, use_grad_guidance)``.  Consecutive spans of
    one style or one color merge into one prompt; a size ``"Npx"`` weighs
    N / 3, negated under ``strike``."""
    base_text_prompt = ""
    style_text_prompts: List[str] = []
    footnote_text_prompts: List[str] = []
    footnote_target_tokens: List[str] = []
    color_text_prompts: List[str] = []
    color_rgbs: List[np.ndarray] = []
    color_names: List[str] = []
    size_text_prompts_and_sizes: List[List[Any]] = []
    prev_style = None
    prev_color = None
    use_grad_guidance = False

    for span in payload["ops"]:
        text = span["insert"].rstrip("\n")
        base_text_prompt += text
        if text == " ":
            continue
        attrs = span.get("attributes")
        if not attrs:
            prev_style = None
            continue
        if "font" in attrs:
            style = font2style(attrs["font"])
            if prev_style == style:
                prev_text = style_text_prompts[-1].split("in the style of")[0]
                style_text_prompts[-1] = (
                    prev_text + " " + text + f" in the style of {style}")
            else:
                style_text_prompts.append(text + f" in the style of {style}")
            prev_style = style
        else:
            prev_style = None
        if "link" in attrs:
            footnote_text_prompts.append(attrs["link"])
            footnote_target_tokens.append(text)
        font_size = 1.0
        if "size" in attrs and "strike" not in attrs:
            font_size = float(attrs["size"][:-2]) / 3.0
        elif "size" in attrs and "strike" in attrs:
            font_size = -float(attrs["size"][:-2]) / 3.0
        if "color" in attrs:
            use_grad_guidance = True
            rgb = hex_to_rgb(attrs["color"])
            name = find_nearest_color(rgb)
            if prev_color is not None and np.allclose(prev_color, rgb):
                color_text_prompts[-1] = color_text_prompts[-1] + " " + text
            else:
                color_rgbs.append(rgb)
                color_names.append(name)
                color_text_prompts.append(text)
            prev_color = rgb
        if font_size != 1.0:
            size_text_prompts_and_sizes.append([text, font_size])

    return (base_text_prompt, style_text_prompts, footnote_text_prompts,
            footnote_target_tokens, color_text_prompts, color_names,
            color_rgbs, size_text_prompts_and_sizes, use_grad_guidance)
