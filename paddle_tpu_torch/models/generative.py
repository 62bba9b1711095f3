"""Generative demo models — the counterpart of
``paddle_tpu/models/generative.py``: the MLP ``GAN`` and ``VAE`` of the
reference's gan/vae demos.

The GAN trains as two steps over one parameter tree, as in JAX: the
discriminator's loss (the fake detached from the generator) and the
generator's, each with its own optimizer moving only its half
(:meth:`GAN.split_grads`: the ``g*`` and the ``d*`` subtrees). Where JAX
takes a PRNG key, the VAE takes an explicit ``torch.Generator``; its
draw is kept apart from the arithmetic (:meth:`VAE._loss_from_eps`), so
the arithmetic can be held to JAX's on the noise JAX drew. Parameter
names are the JAX tree's (``g1..g3``, ``d1..d3``; ``enc1``, ``enc_mu``,
``enc_lv``, ``dec1``, ``dec2``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..nn import Linear, Module
from ..ops import loss as L


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return L.sigmoid_cross_entropy_with_logits(
        logits, torch.full_like(logits, target)).mean()


class GAN(Module):
    """MLP GAN (gan_conf.py shapes): G maps noise to a sample, D a sample
    to a real-or-fake logit."""

    def __init__(self, data_dim: int = 784, noise_dim: int = 64,
                 hidden: int = 128):
        super().__init__()
        self.noise_dim = noise_dim
        self.g1 = Linear(noise_dim, hidden, act="relu")
        self.g2 = Linear(hidden, hidden, act="relu")
        self.g3 = Linear(hidden, data_dim, act="tanh")
        self.d1 = Linear(data_dim, hidden, act="relu")
        self.d2 = Linear(hidden, hidden, act="relu")
        self.d3 = Linear(hidden, 1)

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        return self.g3(self.g2(self.g1(z)))

    def discriminate(self, x: torch.Tensor) -> torch.Tensor:
        return self.d3(self.d2(self.d1(x)))[..., 0]

    def d_loss(self, real: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """D's loss: real against 1, the (detached) fake against 0."""
        fake = self.generate(z).detach()
        return (_bce(self.discriminate(real), 1.0)
                + _bce(self.discriminate(fake), 0.0))

    def g_loss(self, z: torch.Tensor) -> torch.Tensor:
        """G's non-saturating loss: the fake against 1."""
        return _bce(self.discriminate(self.generate(z)), 1.0)

    @staticmethod
    def split_grads(grads: Mapping) -> Tuple[Dict, Dict]:
        """(the generator's subtrees, the discriminator's)."""
        g = {k: v for k, v in grads.items() if k.startswith("g")}
        d = {k: v for k, v in grads.items() if k.startswith("d")}
        return g, d


class VAE(Module):
    """MLP VAE (vae_conf.py): encoder -> (mu, logvar) -> a reparameterized
    sample -> decoder; the ELBO loss (Bernoulli reconstruction of x
    scaled to [0, 1], plus the KL to N(0, 1))."""

    def __init__(self, data_dim: int = 784, latent: int = 32,
                 hidden: int = 128):
        super().__init__()
        self.latent = latent
        self.enc1 = Linear(data_dim, hidden, act="relu")
        self.enc_mu = Linear(hidden, latent)
        self.enc_lv = Linear(hidden, latent)
        self.dec1 = Linear(latent, hidden, act="relu")
        self.dec2 = Linear(hidden, data_dim)

    def encode(self, x: torch.Tensor):
        h = self.enc1(x)
        return self.enc_mu(h), self.enc_lv(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.dec2(self.dec1(z))

    def loss(self, x: torch.Tensor, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        """The negative ELBO, eps ~ N(0, 1) drawn from ``generator`` (on
        x's device)."""
        eps = torch.randn((x.shape[0], self.latent), generator=generator,
                          dtype=x.dtype, device=x.device)
        return self._loss_from_eps(x, eps)

    def _loss_from_eps(self, x: torch.Tensor, eps: torch.Tensor
                       ) -> torch.Tensor:
        mu, logvar = self.encode(x)
        z = mu + torch.exp(0.5 * logvar) * eps
        logits = self.decode(z)
        x01 = (x + 1.0) / 2.0
        rec = L.sigmoid_cross_entropy_with_logits(logits, x01).sum(-1).mean()
        kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar),
                              -1).mean()
        return rec + kl

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator], n: int
               ) -> torch.Tensor:
        """n samples in [0, 1] from codes drawn from ``generator`` (on the
        model's device)."""
        dev = self.dec1.w.device
        z = torch.randn((n, self.latent), generator=generator,
                        dtype=self.dec1.w.dtype, device=dev)
        return torch.sigmoid(self.decode(z))
