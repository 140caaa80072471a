"""synth-CIFAR: deterministic 10-class 32x32x3 image dataset (numpy copy of
`repro.data.synth_cifar`: the same generator, bit-identical arrays).

CIFAR-10/MNIST are not bundled with the repository (DESIGN.md §8); the
paper's accuracy experiments run on this generator instead.  Each class
is a mixture of oriented Gabor textures + class-tinted color field; additive
Gaussian pixel noise controls task difficulty.  Linearly separable it is
not: reduced CNNs reach high accuracy only after a few hundred steps, and
noise injected into their weights degrades accuracy layer-dependently —
which is the property the hybrid-mapping experiment needs.
"""

from __future__ import annotations

import numpy as np

_N_CLASSES = 10


def _gabor(size: int, theta: float, freq: float, phase: float) -> np.ndarray:
    ax = np.arange(size) - size / 2
    xx, yy = np.meshgrid(ax, ax)
    xr = xx * np.cos(theta) + yy * np.sin(theta)
    yr = -xx * np.sin(theta) + yy * np.cos(theta)
    return np.exp(-(xr ** 2 + yr ** 2) / (2 * (size / 3) ** 2)) \
        * np.cos(2 * np.pi * freq * xr + phase)


def synth_cifar(n: int, seed: int = 0, noise: float = 1.1,
                size: int = 32):
    """Returns (images (n, size, size, 3) f32 in [-1, 1], labels (n,)).

    Deliberately HARD: neighbouring classes differ by ~9 deg of texture
    orientation with per-sample rotation jitter of ~6 deg, weak color
    tints and strong pixel noise — so clean QAT models land in the
    75-95% band and analog weight noise produces measurable, layer-
    dependent degradation (the regime of the paper's Fig. 6/10)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, _N_CLASSES, size=n)
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        k = labels[i]
        theta = np.pi / 26.0 * k + rng.normal(0, 0.12)
        freq = 0.085 + 0.006 * (k % 5) + rng.normal(0, 0.005)
        phase = rng.uniform(0, 2 * np.pi)
        tint = np.array([np.sin(2.1 * k), np.cos(1.3 * k),
                         np.sin(0.7 * k + 1)], np.float32) * 0.05
        w = rng.uniform(0.5, 1.0)
        img = w * _gabor(size, theta, freq, phase) \
            + (1 - w) * _gabor(size, theta + 0.4, freq * 1.6,
                               phase + 1.0)
        contrast = rng.uniform(0.5, 1.2)
        imgs[i] = contrast * img[..., None] + tint[None, None, :]
    imgs += rng.normal(0, noise, imgs.shape).astype(np.float32)
    return np.clip(imgs, -1, 1), labels.astype(np.int32)


def train_test_split(n_train: int = 2048, n_test: int = 512, seed: int = 0,
                     noise: float = 0.35):
    xtr, ytr = synth_cifar(n_train, seed=seed, noise=noise)
    xte, yte = synth_cifar(n_test, seed=seed + 1, noise=noise)
    return (xtr, ytr), (xte, yte)
