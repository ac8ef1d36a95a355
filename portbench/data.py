"""Seeded data at a configuration's shape, made on the device.

Every draw comes from a ``torch.Generator`` on the run's device, seeded
from ``(seed, stream)``, so one seed gives the same rows on every run and
each stream (structure, base rows, queries, training sample, the
trainers' starts) is independent of the others.

The generator (a configuration's ``generator``, ``kind`` ``mixture``) is
a Gaussian mixture in ``dim`` dimensions: ``components`` centres,
full-rank isotropic spread around each plus a shared low-rank part, and
unequal component weights, fixed quantiles of a log-normal law. The
mixture itself (centres, weights, low-rank basis) comes from the
configuration's ``data_seed``.
"""

from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream of one seed on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) & _MASK)
    return g


def _normal_quantiles(n: int, device) -> torch.Tensor:
    p = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)


class Mixture:
    """The mixture's structure, drawn from the configuration's
    ``data_seed``."""

    def __init__(self, gen: dict, dim: int, device):
        if gen["kind"] != "mixture":
            raise ValueError(f"no generator of kind {gen['kind']!r}")
        self.dim = int(dim)
        self.gen = gen
        self.device = torch.device(device)
        g = generator(int(gen["data_seed"]), 0, device)
        c, r = int(gen["components"]), int(gen["latent_rank"])
        self.centres = torch.randn(c, dim, generator=g, device=device) * float(gen["centre_scale"])
        self.basis = torch.randn(r, dim, generator=g, device=device) * (
            float(gen["latent_scale"]) / math.sqrt(r))
        w = torch.exp(float(gen["weight_sigma"]) * _normal_quantiles(c, device))
        perm = torch.randperm(c, generator=g, device=device)
        self.weights = (w / w.sum())[perm].to(torch.float32)

    def rows(self, n: int, g: torch.Generator, out: torch.Tensor = None,
             block: int = 262_144) -> torch.Tensor:
        """``n`` rows drawn with ``g`` into ``out`` (``[n, dim]`` f32),
        ``block`` rows at a time."""
        dev, d = self.device, self.dim
        if out is None:
            out = torch.empty(n, d, dtype=torch.float32, device=dev)
        noise = float(self.gen["noise_scale"])
        for lo in range(0, n, block):
            b = min(block, n - lo)
            lab = torch.multinomial(self.weights, b, replacement=True, generator=g)
            x = out[lo:lo + b]
            torch.mm(torch.randn(b, self.basis.shape[0], generator=g, device=dev), self.basis,
                     out=x)
            x += self.centres[lab]
            x += noise * torch.randn(b, d, generator=g, device=dev)
        return out


def ivf_data(cfg: dict, seed: int, device):
    """``(base [n_base, d], queries [n_queries, d], train [n_train, d])``
    of an IVF configuration.

    The base rows, the training sample (drawn from them without
    replacement) and the query pool (a separate draw of the same law) come
    from the configuration's ``data_seed``, so every run builds the same
    lists and answers the same queries: the same work on every seed.
    ``seed`` draws the order in which the base rows are added (and so
    their ids); the traffic drivers draw the order of the queries from
    it."""
    fixed = int(cfg["generator"]["data_seed"])
    mix = Mixture(cfg["generator"], cfg["dim"], device)
    base = mix.rows(cfg["n_base"], generator(fixed, 1, device))
    pick = torch.randperm(cfg["n_base"], generator=generator(fixed, 3, device),
                          device=device)[:cfg["n_train"]]
    train = base[pick].contiguous()
    order = torch.randperm(cfg["n_base"], generator=generator(seed, 4, device), device=device)
    queries = mix.rows(cfg["n_queries"], generator(fixed, 2, device))
    return base[order].contiguous(), queries, train
