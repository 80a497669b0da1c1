"""TPS equivariance loss on part moments, twin of
partseg_tpu/losses/equivariance.py:

    L_eq = mean_k ‖T(μ_k(x_s)) − μ_k(x_a)‖²
         + λ_Σ mean_k ‖J(μ_s) Σ_k(x_s) J(μ_s)ᵀ − Σ_k(x_a)‖_F

x_s(u) = x(T(u)), so a part found at μ_s in the warped view sits at
T(μ_s) in the original frame, and its covariance moves as J Σ Jᵀ.
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.augment.tps import TPSParams, TPSSampler


def equivariance_loss(sampler: TPSSampler, tps: TPSParams, mu_s: torch.Tensor,
                      sigma_s: torch.Tensor, mu_a: torch.Tensor, sigma_a: torch.Tensor,
                      sigma_weight: float = 1.0) -> tuple[torch.Tensor, dict]:
    """Returns (scalar loss, metrics dict). All moment math in f32."""
    mu_pred = sampler.transform_points(tps, mu_s.float())
    jac = sampler.jacobian(tps, mu_s)                                    # [B, K, 2, 2]
    sig_pred = torch.einsum("bkij,bkjl,bkml->bkim", jac, sigma_s.float(), jac)
    mu_err = torch.sum((mu_pred - mu_a.float()) ** 2, dim=-1)
    sig_err = torch.sqrt(torch.sum((sig_pred - sigma_a.float()) ** 2, dim=(-2, -1)) + 1e-12)
    loss_mu = mu_err.mean()
    loss_sig = sig_err.mean()
    return loss_mu + sigma_weight * loss_sig, {"equiv_mu": loss_mu, "equiv_sigma": loss_sig}
