"""Procedural scalar fields standing in for the paper's datasets.

The paper evaluates on Nyx (cosmology), viscous fingering, Red Sea, climate
(CESM/IVT), combustion, molecular (AT) data — none of which ship with this
container. Each generator below reproduces the *topological character* of
one dataset class (multi-scale smooth extrema, filamentary structure,
turbulent small-scale critical points) so edit ratios / iteration counts
land in comparable regimes. All generators are deterministic in (name,
shape, seed).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np


def _freq_grid(shape):
    axes = [np.fft.fftfreq(s) for s in shape]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.sqrt(sum(m * m for m in mesh))


def _spectral_field(shape, slope, seed) -> np.ndarray:
    """Gaussian random field with power-law spectrum |k|^slope."""
    rng = np.random.default_rng(seed)
    white = rng.normal(size=shape)
    k = _freq_grid(shape)
    amp = np.where(k > 0, np.power(np.maximum(k, 1e-9), slope / 2.0), 0.0)
    f = np.fft.ifftn(np.fft.fftn(white) * amp).real
    f = (f - f.mean()) / (f.std() + 1e-12)
    return f.astype(np.float32)


def nyx_like(shape=(64, 64, 64), seed=1) -> np.ndarray:
    """Cosmology-like: log-normal density with filamentary walls (steep
    spectrum + exponentiation sharpens peaks like dark-matter density)."""
    g = _spectral_field(shape, slope=-2.5, seed=seed)
    return np.exp(1.2 * g).astype(np.float32)


def viscous_fingering_like(shape=(64, 64, 64), seed=2) -> np.ndarray:
    """High topological complexity: mid-scale turbulence plus a density
    gradient (salt collecting at the bottom of the cylinder)."""
    g = _spectral_field(shape, slope=-1.2, seed=seed)
    z = np.linspace(0, 1, shape[0], dtype=np.float32)
    grad = z.reshape(-1, *([1] * (len(shape) - 1)))
    return (g + 2.0 * grad).astype(np.float32)


def climate_like(shape=(180, 360), seed=3) -> np.ndarray:
    """IVT-like 2D: smooth large-scale bands with embedded filaments."""
    g = _spectral_field(shape, slope=-3.0, seed=seed)
    bands = np.sin(np.linspace(0, 4 * np.pi, shape[0], dtype=np.float32))
    return (g + 0.8 * bands[:, None]).astype(np.float32)


def combustion_like(shape=(64, 64, 64), seed=4) -> np.ndarray:
    """Flame-like: sharp reaction fronts = tanh of a smooth field."""
    g = _spectral_field(shape, slope=-2.0, seed=seed)
    return np.tanh(3.0 * g).astype(np.float32)


def molecular_like(shape=(48, 48, 24), seed=5) -> np.ndarray:
    """Electron-density-like: superposition of atomic Gaussians."""
    rng = np.random.default_rng(seed)
    coords = [np.arange(s, dtype=np.float32) for s in shape]
    mesh = np.meshgrid(*coords, indexing="ij")
    f = np.zeros(shape, np.float32)
    n_atoms = max(8, int(np.prod(shape) // 2000))
    for _ in range(n_atoms):
        c = [rng.uniform(0, s) for s in shape]
        w = rng.uniform(1.5, 4.0)
        r2 = sum((m - ci) ** 2 for m, ci in zip(mesh, c))
        f += rng.uniform(0.5, 2.0) * np.exp(-r2 / (2 * w * w))
    return f.astype(np.float32)


def heated_flow_like(shape=(150, 450), seed=6) -> np.ndarray:
    """2D flow past a heated cylinder: vortex street pattern."""
    g = _spectral_field(shape, slope=-1.8, seed=seed)
    y, x = np.meshgrid(np.linspace(-1, 1, shape[0], dtype=np.float32),
                       np.linspace(0, 6, shape[1], dtype=np.float32),
                       indexing="ij")
    street = np.sin(3 * x - 2 * y) * np.exp(-np.abs(y) * 1.5)
    return (0.6 * g + street).astype(np.float32)


FIELD_GENERATORS: Dict[str, Callable[..., np.ndarray]] = {
    "nyx": nyx_like,
    "fingering": viscous_fingering_like,
    "climate": climate_like,
    "combustion": combustion_like,
    "molecular": molecular_like,
    "heated_flow": heated_flow_like,
}


def synthetic_field(name: str, shape: Tuple[int, ...] | None = None,
                    seed: int | None = None) -> np.ndarray:
    """A procedural stand-in for one of the paper's datasets (see
    FIELD_GENERATORS for names); deterministic per (name, shape, seed)."""
    gen = FIELD_GENERATORS[name]
    kwargs = {}
    if shape is not None:
        kwargs["shape"] = tuple(shape)
    if seed is not None:
        kwargs["seed"] = seed
    return gen(**kwargs)
