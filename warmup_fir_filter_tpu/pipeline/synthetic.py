"""Synthetic test-image corpus generator.

The reference ships seven grayscale images spanning tiny-exact to
13.5-Mpixel stress cases (SURVEY.md P17).  Those binaries stay upstream;
this module synthesizes an equivalent corpus — deterministic, seeded,
and spanning the same coverage intents — so the framework runs fully
self-contained (``--synthesize-corpus`` on the CLI):

- smooth gradients (low-frequency content, sub-LSB quantization error),
- checkerboards / alternating stripes (Nyquist content, edge response),
- uniform noise (the reference's worst-case for the edge filter),
- hard step edges + saturated regions (clipping / saturation metrics),
- one large stress image.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from warmup_fir_filter_tpu.utils.imageio import save_gray_png

DEFAULT_SPECS: tuple[tuple[str, str, tuple[int, int]], ...] = (
    ("img_001_gradient", "gradient", (512, 768)),
    ("img_002_checker", "checker", (256, 256)),
    ("img_003_stripes", "stripes", (300, 400)),
    ("img_004_tiny", "gradient", (64, 64)),
    ("img_005_noise", "noise", (64, 64)),
    ("img_006_steps", "steps", (480, 640)),
    ("img_007_large_mix", "mix", (1536, 2048)),
)

#: The reference corpus's seven image sizes (SURVEY.md P17, W×H 1280×853,
#: 640×762, 1280×854, 64×64, 64×64 noise, 4499×2999, 1280×641), as
#: (rows, cols): 67,975,252 samples over the 28-case matrix.
REFERENCE_SPECS: tuple[tuple[str, str, tuple[int, int]], ...] = (
    ("img_001_gradient", "gradient", (853, 1280)),
    ("img_002_checker", "checker", (762, 640)),
    ("img_003_stripes", "stripes", (854, 1280)),
    ("img_004_tiny", "gradient", (64, 64)),
    ("img_005_noise", "noise", (64, 64)),
    ("img_006_large_mix", "mix", (2999, 4499)),
    ("img_007_steps", "steps", (641, 1280)),
)


def _render(kind: str, shape: tuple[int, int],
            rng: np.random.Generator) -> np.ndarray:
    rows, cols = shape
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    if kind == "gradient":
        img = (r * 255.0 / max(rows - 1, 1) + c * 255.0 / max(cols - 1, 1)) / 2.0
    elif kind == "checker":
        img = ((r // 8 + c // 8) % 2) * 255.0
    elif kind == "stripes":
        img = ((c // 4) % 2) * 255.0 * np.ones((rows, 1))
    elif kind == "noise":
        img = rng.integers(0, 256, size=shape).astype(np.float64)
    elif kind == "steps":
        img = (c * 8 // cols) * (255.0 / 7.0) * np.ones((rows, 1))
        img[: rows // 4] = 0.0
        img[-rows // 4 :] = 255.0
    elif kind == "mix":
        img = 127.5 + 90.0 * np.sin(2 * np.pi * r / 97.0) * np.cos(
            2 * np.pi * c / 53.0
        )
        noise_band = rng.integers(0, 256, size=(rows // 8, cols))
        img[:rows // 8] = noise_band
    else:
        raise ValueError(f"Unknown synthetic kind={kind}")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def synthesize_corpus(
    image_dir: Path,
    *,
    specs=DEFAULT_SPECS,
    seed: int = 20260817,
    overwrite: bool = False,
) -> list[Path]:
    """Write the synthetic corpus as PNGs; returns the file list."""
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for stem, kind, shape in specs:
        path = image_dir / f"{stem}.png"
        if not path.exists() or overwrite:
            save_gray_png(path, _render(kind, shape, rng))
        paths.append(path)
    return paths
