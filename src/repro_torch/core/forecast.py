"""FCFP forecasting: harmonic regression + decaying residual pattern
(torch twin of ``repro.core.forecast``).

A Fourier basis over daily / weekly / annual periods is fit by least
squares, plus the last day's residual pattern decaying toward the fit.
``forecast_regions`` fits every region at once (the regions share the
design matrix, so they are the right-hand sides of one ``lstsq``) in place
of the reference's ``vmap``.  ``green_window_signals`` reduces a forecast
tensor to the green-window planner's inputs.

``torch.linalg.lstsq`` is not bit-equal to ``jnp.linalg.lstsq``: the CPU
uses the SVD driver ``gelsd`` (nearest to JAX's SVD solve), the card the
only driver it has, ``gels`` (QR; the design matrix has full column
rank).  An f32 fit rounds differently with each driver and library, and
on the 336-hour windows of ``sim_scale``'s seed-1 traces LAPACK's f32 fit
left the reference by more than the tests' 1e-5 of a region's forecast
scale.  So the fit runs in float64 and rounds to f32 once, at the end:
the drivers then agree with each other, and with the reference within
its own f32 rounding.  ``green_window_signals`` takes its discounted mean
the same way (weights and sum in float64, one f32 rounding), so the card
and the CPU give the same planner signals bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

PERIODS = (24.0, 168.0, 8760.0)
HARMONICS = (3, 2, 1)


def _active_periods(T: int) -> Tuple[Tuple[float, int], ...]:
    """Periods with at least one full cycle of support in a T-hour window
    (a much longer harmonic is near-collinear with the intercept)."""
    return tuple((p, nh) for p, nh in zip(PERIODS, HARMONICS) if T >= p)


def _design(t: torch.Tensor,
            periods: Tuple[Tuple[float, int], ...]) -> torch.Tensor:
    """Fourier design matrix (T, F) over the given (period, harmonics)."""
    cols = [torch.ones_like(t)]
    for period, nh in periods:
        for k in range(1, nh + 1):
            w = 2 * math.pi * k * t / period
            cols.append(torch.cos(w))
            cols.append(torch.sin(w))
    return torch.stack(cols, dim=-1)


def _lstsq(X: torch.Tensor, Y: torch.Tensor,
           driver: Optional[str] = None) -> torch.Tensor:
    if driver is None:
        driver = "gelsd" if X.device.type == "cpu" else "gels"
    return torch.linalg.lstsq(X, Y, driver=driver).solution


def forecast_regions(history: torch.Tensor, horizon: int, t0: int = 0,
                     driver: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit on ``history`` (R, T) starting at absolute hour t0; forecast the
    next ``horizon`` hours.  Returns (forecast (R, horizon), coef (R, 13));
    ``coef`` is padded to the full-basis width.  ``driver`` names the
    ``torch.linalg.lstsq`` driver (default: the device's, see above)."""
    R, T = history.shape
    dev = history.device
    periods = _active_periods(T)
    n_full = 1 + 2 * sum(HARMONICS)
    # the fit in float64, rounded to f32 once at the end: what an f32 fit
    # rounds depends on its device and library (see the module note)
    hist = history.to(torch.float64)
    t_hist = t0 + torch.arange(T, dtype=torch.float64, device=dev)
    X = _design(t_hist, periods)                       # (T, F)
    coef = _lstsq(X, hist.T, driver).T                 # (R, F)
    resid = hist - coef @ X.T                          # (R, T)
    # the last day's residual pattern persists, decaying toward the fit;
    # histories shorter than a day cycle through their L residuals
    h = torch.arange(horizon, dtype=torch.float64, device=dev)
    L = min(T, 24)
    pattern = resid[:, -L:][:, torch.remainder(h.to(torch.int64), L)]
    decay = 0.82 ** (h / 24.0 + 0.25)
    t_fut = t0 + T + h
    fc = coef @ _design(t_fut, periods).T + pattern * decay
    coef = torch.nn.functional.pad(coef, (0, n_full - coef.shape[1]))
    return (torch.clamp_min(fc, 0.0).to(torch.float32),
            coef.to(torch.float32))


def fit_forecast(history: torch.Tensor, horizon: int, t0: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One region: (forecast (horizon,), coef (13,))."""
    fc, coef = forecast_regions(history[None], horizon, t0)
    return fc[0], coef[0]


def persistence_regions(history: torch.Tensor, horizon: int) -> torch.Tensor:
    """Persistence-of-day: cycle the last ``min(T, 24)`` observed hours of
    each region (R, T) across the horizon."""
    L = min(history.shape[-1], 24)
    reps = (horizon + L - 1) // L
    return history[..., -L:].repeat(*([1] * (history.dim() - 1)),
                                    reps)[..., :horizon]


def persistence_forecast(history: torch.Tensor, horizon: int) -> torch.Tensor:
    return persistence_regions(history, horizon)


def green_window_signals(fc: torch.Tensor, region_pue: torch.Tensor,
                         lookahead_h: int, discount: float = 0.9
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Green-window extraction over a region forecast tensor.

    ``fc`` is ``(..., R, H)`` forecast CI with any leading batch axes
    (one epoch ``(R, H)``, a trajectory ``(T, R, H)``, lanes ``(L, T, R,
    H)``); ``region_pue`` is the per-region representative PUE (``+inf``
    for regions with no nodes, so they never win a min).  Returns

    - ``la_ci`` ``(..., R)``: the discount-weighted mean forecast CI over
      the next ``L = min(lookahead_h, H)`` hours (weights ``discount**h``,
      normalized), in float64 and rounded to f32 once;
    - ``gw_min`` ``(...,)``: the greenest CFP rate (CI x PUE, an f32
      product as the reference takes it) at any single hour in the window.
    """
    L = max(1, min(int(lookahead_h), fc.shape[-1]))
    w = float(discount) ** torch.arange(L, dtype=torch.float64,
                                        device=fc.device)
    w = w / w.sum()
    la_ci = (fc[..., :L].to(torch.float64) * w).sum(-1).to(torch.float32)
    # node-less regions are masked explicitly: a forecast clamped at
    # exactly 0.0 times the +inf sentinel would be NaN
    rp = region_pue.to(torch.float32)
    gw = torch.where(torch.isfinite(rp)[..., :, None],
                     fc[..., :L] * rp[..., :, None], torch.inf)
    return la_ci, gw.amin(dim=(-2, -1))


def forecast_skill(history: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """MAE ratio vs 24h-persistence baseline (<1 means we beat persistence)."""
    fc, _ = fit_forecast(history, test.shape[0])
    mae = torch.mean(torch.abs(fc - test))
    persist = persistence_forecast(history, test.shape[0])
    mae_p = torch.mean(torch.abs(persist - test))
    return mae / torch.clamp_min(mae_p, 1e-9)
