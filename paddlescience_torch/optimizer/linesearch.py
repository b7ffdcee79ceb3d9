"""optax's zoom line search, copied by hand (counterpart of optax 0.2.6
``_src/linesearch.py``: ``_cubicmin``, ``_quadmin``, ``zoom_linesearch``
and ``scale_by_zoom_linesearch``, the search the JAX package's ``LBFGS``
runs).

The search looks for a step size eta along ``updates`` u from ``params`` w
that satisfies the sufficient decrease (Armijo) criterion

    f(w + eta u) <= f(w) + slope_rtol * eta * <u, grad f(w)>

(or, near a minimum, Hager and Zhang's approximate decrease) and the
small-curvature criterion |<grad f(w + eta u), u>| <= curv_rtol * |<grad
f(w), u>|. Phase 1 (Nocedal and Wright, Algorithm 3.5) grows the step by
``increase_factor`` until an interval holding an acceptable step is
found; phase 2 (Algorithm 3.6) zooms into it, taking the minimiser of a
cubic through three points when it lies well inside, else of a quadratic,
else the midpoint. When ``max_linesearch_steps`` trials end without a
step that meets both criteria, the search returns its "safe" step, the
best one that met the decrease criterion (0 when none did, unless the
values were not finite).

optax runs the search as a traced while-loop over a state of device
scalars. Here it is a host loop: every trial evaluates the objective once
(``value_and_grad(params + eta * updates)`` on the parameters' device) and
reads its value and slope back as float32 scalars; the decisions are taken
in numpy float32, as optax takes them in float32 on the device. The
search's settings are those of ``scale_by_zoom_linesearch`` with the JAX
package's arguments: ``initial_guess_strategy="keep"`` (the first trial is
the step accepted last time, 1 at the start), tolerance 0, no largest step.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["ZoomLineSearch", "cubicmin", "quadmin"]

f32 = np.float32
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def cubicmin(a, fa, fpa, b, fb, c, fc) -> np.float32:
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN when there is none (optax ``_cubicmin``)."""
    with np.errstate(all="ignore"):
        C = fpa
        db = f32(b - a)
        dc = f32(c - a)
        denom = f32(f32(db * dc) ** 2 * f32(db - dc))
        v0 = f32(fb - fa - f32(C * db))
        v1 = f32(fc - fa - f32(C * dc))
        A = f32(f32(f32(dc * dc) * v0) + f32(-f32(db * db) * v1)) / denom
        B = f32(f32(-f32(f32(dc * dc) * dc) * v0) + f32(f32(f32(db * db) * db) * v1)) / denom
        radical = f32(f32(B * B) - f32(f32(f32(3.0) * A) * C))
        return f32(a + f32(f32(-B + np.sqrt(radical)) / f32(f32(3.0) * A)))


def quadmin(a, fa, fpa, b, fb) -> np.float32:
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax ``_quadmin``)."""
    with np.errstate(all="ignore"):
        db = f32(b - a)
        B = f32(f32(fb - fa - f32(fpa * db)) / f32(db * db))
        return f32(a - f32(fpa / f32(f32(2.0) * B)))


# scale_by_zoom_linesearch's defaults, the JAX package's settings
TOL = f32(0.0)
INCREASE_FACTOR = f32(2.0)
SLOPE_RTOL = f32(1e-4)
APPROX_SLOPE_FACTOR = f32(2 * 1e-4 - 1.0)  # 2 slope_rtol - 1: a Python constant in optax, then float32
CURV_RTOL = f32(0.9)
APPROX_DEC_RTOL = f32(1e-6)
STEPSIZE_PRECISION = f32(1e-5)


class ZoomLineSearch:
    """``scale_by_zoom_linesearch(max_linesearch_steps)`` on flat float32
    parameter vectors. :meth:`search` returns the accepted step size and
    leaves in :attr:`state` what optax keeps for the next step: the step
    size (the next first guess), the value and gradient at the accepted
    point (what ``optax.value_and_grad_from_state`` hands the next step)
    and the search's info (trials, decrease and curvature errors)."""

    def __init__(self, max_linesearch_steps: int):
        self.max_linesearch_steps = int(max_linesearch_steps)
        self.state: Dict[str, torch.Tensor] = {}
        self.trace = []  # the phase of each trial of the last search: "interval" or "zoom"
        self.failed = False  # whether the last search ended without a step meeting both criteria

    def init_state(self, params: torch.Tensor) -> None:
        """optax ``init_fn``: step size 1, value +inf, gradient 0, no trials."""
        dev = params.device
        self.state = {
            "learning_rate": torch.ones((), dtype=torch.float32, device=dev),
            "value": torch.full((), float("inf"), dtype=torch.float32, device=dev),
            "grad": torch.zeros_like(params),
            "num_linesearch_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "decrease_error": torch.full((), float("inf"), dtype=torch.float32, device=dev),
            "curvature_error": torch.full((), float("inf"), dtype=torch.float32, device=dev),
        }

    # ------------------------------------------------------------ criteria --

    @staticmethod
    def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
        """The Armijo error, or Hager and Zhang's approximate-decrease error
        where that is smaller (the values then being within 1e-6 of the
        start's); 0 when met, inf when not finite."""
        with np.errstate(all="ignore"):
            err = f32(f32(value_step - value_init) - f32(f32(SLOPE_RTOL * stepsize) * slope_init))
            approx = f32(slope_step - f32(APPROX_SLOPE_FACTOR * slope_init))
            delta = f32(f32(value_step - value_init) - f32(APPROX_DEC_RTOL * abs(value_init)))
            err = np.maximum(np.minimum(np.maximum(approx, delta), err), f32(0.0))
            return f32(np.inf) if np.isnan(err) else f32(err)

    @staticmethod
    def _curvature_error(slope_step, slope_init):
        with np.errstate(all="ignore"):
            err = np.maximum(f32(abs(slope_step) - f32(CURV_RTOL * abs(slope_init))), f32(0.0))
            return f32(np.inf) if np.isnan(err) else f32(err)

    # -------------------------------------------------------------- search --

    def search(self, params: torch.Tensor, updates: torch.Tensor, value: torch.Tensor, grad: torch.Tensor,
               value_and_grad: ValueAndGrad) -> torch.Tensor:
        """One search along ``updates`` from ``params`` (the value and
        gradient there given). Returns the accepted step size as a float32
        device scalar and updates :attr:`state`."""
        dev = params.device
        guess = f32(self.state["learning_rate"].item())  # initial_guess_strategy="keep"
        value_init, slope_init = (f32(v) for v in torch.stack([value.float(), torch.dot(updates, grad)]).tolist())

        def on_line(stepsize):
            step = params + torch.tensor(stepsize, device=dev) * updates
            v, g = value_and_grad(step)
            v_f, s_f = torch.stack([v.detach().float(), torch.dot(g, updates)]).tolist()
            return v.detach().float(), g, f32(v_f), f32(s_f)

        # the running state, as optax's ZoomLinesearchState (the device tensors beside their host scalars)
        count = 0
        stepsize, val_t, grad_t, val, slope = f32(0.0), value.detach().float(), grad, value_init, slope_init
        decrease_error = curvature_error = f32(np.inf)
        interval_found = done = failed = False
        low, value_low, slope_low = f32(0.0), value_init, slope_init
        high, value_high, slope_high = f32(0.0), value_init, slope_init
        cubic_ref, value_cubic_ref = f32(0.0), value_init
        safe_stepsize, safe_val_t, safe_grad_t, safe_value = f32(0.0), val_t, grad, value_init
        self.trace = []
        tol = TOL

        while not (done or failed):
            if not interval_found:  # _search_interval
                self.trace.append("interval")
                prev_stepsize, prev_value, prev_slope = stepsize, val, slope
                new_stepsize = guess if count == 0 else f32(INCREASE_FACTOR * prev_stepsize)
                new_val_t, new_grad_t, new_value, new_slope = on_line(new_stepsize)
                decrease_error = self._decrease_error(new_stepsize, new_value, new_slope, value_init, slope_init)
                curvature_error = self._curvature_error(new_slope, slope_init)
                new_error = max(decrease_error, curvature_error)
                if decrease_error <= tol:
                    safe_stepsize, safe_val_t, safe_grad_t, safe_value = new_stepsize, new_val_t, new_grad_t, new_value
                set_high_to_new = bool(decrease_error > 0.0) or bool(new_value >= prev_value and count > 0)
                set_low_to_new = bool(new_slope >= 0.0) and not set_high_to_new
                if set_low_to_new:
                    low, value_low, slope_low = new_stepsize, new_value, new_slope
                    high, value_high, slope_high = prev_stepsize, prev_value, prev_slope
                else:
                    low, value_low, slope_low = prev_stepsize, prev_value, prev_slope
                    high, value_high, slope_high = new_stepsize, new_value, new_slope
                interval_found = set_high_to_new or set_low_to_new or bool(new_error <= tol)
                done = bool(new_error <= tol)  # no largest step: the search never stops at one
                failed = (count + 1 >= self.max_linesearch_steps) and not done
                cubic_ref, value_cubic_ref = low, value_low
            else:  # _zoom_into_interval
                self.trace.append("zoom")
                with np.errstate(all="ignore"):
                    delta = f32(abs(high - low))
                    left, right = min(high, low), max(high, low)
                    cubic_chk, quad_chk = f32(f32(0.2) * delta), f32(f32(0.1) * delta)
                    too_small_int = bool(delta <= STEPSIZE_PRECISION)
                    middle_cubic = cubicmin(low, value_low, slope_low, high, value_high, cubic_ref, value_cubic_ref)
                    use_cubic = bool(middle_cubic > f32(left + cubic_chk)) and bool(middle_cubic < f32(right - cubic_chk))
                    middle_quad = quadmin(low, value_low, slope_low, high, value_high)
                    use_quad = (not use_cubic) and bool(middle_quad > f32(left + quad_chk)) and bool(
                        middle_quad < f32(right - quad_chk))
                    if use_cubic:
                        middle = middle_cubic
                    elif use_quad:
                        middle = middle_quad
                    else:
                        middle = f32(f32(low + high) / f32(2.0))
                mid_val_t, mid_grad_t, value_middle, slope_middle = on_line(middle)
                decrease_error = self._decrease_error(middle, value_middle, slope_middle, value_init, slope_init)
                curvature_error = self._curvature_error(slope_middle, slope_init)
                new_error = max(decrease_error, curvature_error)
                if decrease_error <= tol and value_middle < safe_value:
                    safe_stepsize, safe_val_t, safe_grad_t, safe_value = middle, mid_val_t, mid_grad_t, value_middle
                done = bool(new_error <= tol)
                set_high_to_middle = bool(decrease_error > 0.0) or bool(value_middle >= value_low)
                secant_interval = f32(slope_middle * f32(high - low))
                set_high_to_low = bool(secant_interval >= 0.0) and not set_high_to_middle
                set_low_to_middle = not set_high_to_middle
                # the new cubic reference: the old high if high moved, else the old low
                if set_high_to_middle or set_high_to_low:
                    new_cubic_ref, new_value_cubic_ref = high, value_high
                else:
                    new_cubic_ref, new_value_cubic_ref = low, value_low
                if set_high_to_middle:
                    high, value_high, slope_high = middle, value_middle, slope_middle
                if set_high_to_low:
                    high, value_high, slope_high = low, value_low, slope_low
                if set_low_to_middle:
                    low, value_low, slope_low = middle, value_middle, slope_middle
                cubic_ref, value_cubic_ref = new_cubic_ref, new_value_cubic_ref
                max_iter_reached = count + 1 >= self.max_linesearch_steps
                failed = (max_iter_reached or (too_small_int and safe_stepsize > 0.0)) and not done
                new_stepsize, new_val_t, new_grad_t, new_value, new_slope = (
                    middle, mid_val_t, mid_grad_t, value_middle, slope_middle)
            count += 1
            stepsize, val_t, grad_t, val, slope = new_stepsize, new_val_t, new_grad_t, new_value, new_slope
            if failed:  # _try_safe_step
                if safe_stepsize > 0.0 or np.isinf(decrease_error):
                    stepsize, val_t, grad_t, val = safe_stepsize, safe_val_t, safe_grad_t, safe_value

        self.failed = failed
        st = self.state
        st["learning_rate"].fill_(float(stepsize))
        st["value"].copy_(val_t)
        st["grad"].copy_(grad_t)
        st["num_linesearch_steps"].fill_(count)
        st["decrease_error"].fill_(float(decrease_error))
        st["curvature_error"].fill_(float(curvature_error))
        return st["learning_rate"]
