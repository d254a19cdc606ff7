"""Model calibration against observed trajectories (counterpart of
`cyclistsocialforce_tpu.calibration`; reference calibration.py:27-624).

`CalibrationData` holds observed tracks (initial state, per-step input
forces, objective states). A calibration replays each track through a
vehicle model driven by the recorded forces and minimises a trajectory
error over model parameters with Nelder-Mead (`scipy.optimize.fmin`,
reference calibration.py:472-526).

The K tracks of a data set advance together as one K-rider population
on `device` in float64, T model steps a replay. On the card one replay
of a data set is captured once as a CUDA graph (`_Replay`): the
candidate's fitted fields are static per-rider columns, written before
each replay, so an objective is one graph launch and not T x ~50 eager
kernel launches. `evaluate_population` replays C candidates x K tracks as
one population of C*K riders, the fitted fields per-rider columns.

The error functions match the reference (SSE over timesteps,
calibration.py:27-51; MAE-SSE over samples, calibration.py:53-77), with
padding masks in place of ragged per-track lists. `fix_speed` clamps the
model speed to the observed desired speed before every step
(calibration.py:448-452).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.params import as_population
from cyclistsocialforce_tpu_torch.state import V, make_state

F64 = torch.float64


@dataclass
class CalibrationData:
    """Stacked observed tracks (reference CalibrationData,
    calibration.py:111-240), numpy arrays:

    s0 : [K, <=8] initial states
    inputs : [K, T, 2] recorded input forces (padded)
    objectives : [K, T, F] objective state observations (padded)
    lengths : [K] valid steps per track
    """

    s0: np.ndarray
    inputs: np.ndarray
    objectives: np.ndarray
    lengths: np.ndarray

    @classmethod
    def from_tracks(cls, tracks):
        """tracks: iterable of (s0, inputs [T_k, 2], objectives [T_k, F])."""
        tracks = [(np.asarray(s, dtype=float), np.asarray(i, dtype=float),
                   np.asarray(o, dtype=float)) for s, i, o in tracks]
        t_max = max(i.shape[0] for _, i, _ in tracks)
        k = len(tracks)
        f = tracks[0][2].shape[1]
        d = max(s.shape[0] for s, _, _ in tracks)
        s0 = np.zeros((k, d))
        inputs = np.zeros((k, t_max, 2))
        objectives = np.zeros((k, t_max, f))
        lengths = np.zeros((k,), dtype=np.int32)
        for j, (s, i, o) in enumerate(tracks):
            s0[j, :s.shape[0]] = s
            inputs[j, :i.shape[0]] = i
            objectives[j, :o.shape[0]] = o
            lengths[j] = i.shape[0]
        return cls(s0, inputs, objectives, lengths)

    def __len__(self):
        return self.s0.shape[0]

    def split(self, train_fraction=0.8, rng=None):
        """Random train/test partition (reference random partitioning,
        calibration.py:200-240)."""
        rng = rng or np.random.default_rng()
        k = len(self)
        perm = rng.permutation(k)
        n_train = max(1, int(round(train_fraction * k)))
        tr, te = perm[:n_train], perm[n_train:]

        def take(idx):
            return CalibrationData(self.s0[idx], self.inputs[idx],
                                   self.objectives[idx], self.lengths[idx])

        return take(tr), take(te)


# --------------------------------------------------------------------------
# error functions (reference calibration.py:27-77), masked
# --------------------------------------------------------------------------


def sse_timesteps(outputs, objectives, mask):
    """Sum of squared errors over all valid timesteps and tracks."""
    return torch.sum(((outputs - objectives) ** 2) * mask[..., None])


def maesse_samples(outputs, objectives, mask):
    """Sum over tracks of (mean absolute error per track)^2."""
    ae = torch.abs(outputs - objectives) * mask[..., None]
    n = torch.clamp(torch.sum(mask, dim=1), min=1) * outputs.shape[-1]
    mae = torch.sum(ae, dim=(1, 2)) / n
    return torch.sum(mae ** 2)


ERROR_FUNCS = {"sse": sse_timesteps, "maesse": maesse_samples}


class _Tracks:
    """A data set on the device, `copies` times over (C candidates x K
    tracks, candidate-major): the initial state, the inputs, objectives
    and mask, and the objective-feature index."""

    def __init__(self, cal, data: CalibrationData, copies: int = 1):
        dev = cal.device

        def t(a):
            a = torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
            return a.repeat((copies,) + (1,) * (a.ndim - 1))

        self.n = len(data) * copies
        self.state = make_state(np.tile(data.s0, (copies, 1)), dtype=F64,
                                device=dev)
        self.inputs = t(data.inputs)                    # [n, T, 2]
        self.objectives = t(data.objectives)
        steps = data.inputs.shape[1]
        self.mask = (torch.arange(steps, device=dev)[None, :]
                     < t(data.lengths)[:, None]).to(F64)
        self.feats = torch.as_tensor(tuple(cal.objective_features),
                                     device=dev)


class _Replay:
    """The objective of one data set behind static buffers: the fitted
    fields are per-rider columns of the population, written with the
    candidate's values before each replay. On CUDA tensors the replay is
    captured once as a CUDA graph (after a warm-up on a side stream, as
    `engine.ChunkRunner` captures a chunk) and each call replays it; on
    the CPU each call runs the same body."""

    def __init__(self, cal, data: CalibrationData, vals):
        self.cal = cal
        self.tracks = _Tracks(cal, data)
        n = self.tracks.n
        self.cols = {key: v.expand((n,) + v.shape).clone()
                     for key, v in cal._field_values(vals).items()}
        self.pop = as_population(cal.params, n, cal.device).replace(
            **self.cols)
        self.graph, self.err = None, None
        if self.tracks.state.s.is_cuda:
            self._capture()

    def _body(self):
        tr = self.tracks
        out = self.cal._replay(self.pop, tr)
        return self.cal._err(out, tr.objectives, tr.mask)

    def _capture(self):
        dev = self.tracks.state.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.err = self._body()

    def __call__(self, vals):
        for key, v in self.cal._field_values(vals).items():
            self.cols[key].copy_(v.expand_as(self.cols[key]))
        if self.graph is None:
            return self._body()
        self.graph.replay()
        return self.err


@dataclass
class Calibration:
    """Nelder-Mead parameter calibration (reference
    DownhillSimplexCalibration, calibration.py:243-624).

    Parameters
    ----------
    model : model module (models.MODELS[...])
    params : base params; the fitted fields are replaced per candidate.
    params_keys : list of param field names to fit.
    train_data / test_data : CalibrationData
    objective_features : state-vector indices compared against the
        objectives (e.g. (0, 1) for x/y; the reference's boolean
        indicator over traj rows, calibration.py:345-350).
    error : "sse" | "maesse" | callable(outputs, objectives, mask) of
        tensors.
    fix_speed : clamp the speed to |input force| before each step
        (calibration.py:448-452).
    params_auxfuncs : optional per-key callables mapping the FULL
        optimizer vector (a float64 tensor [P]) to that field's value
        (reference calibration.py:364-395), e.g. a complex pole set from
        real and imaginary entries: tensor operations, no host reads.
    device : where the replays run (the card unless the caller asks for
        the CPU).
    """

    model: Any
    params: Any
    params_keys: list
    train_data: CalibrationData
    test_data: CalibrationData | None = None
    objective_features: tuple = (0, 1)
    error: Any = "sse"
    fix_speed: bool = True
    maxiter: int = 100
    params_auxfuncs: list | None = None
    verbose: bool = True
    result: dict = field(default_factory=dict)
    device: Any = "cuda"

    def __post_init__(self):
        self._err = (ERROR_FUNCS[self.error]
                     if isinstance(self.error, str) else self.error)
        self._replays = {}

    # ---- core replay ----

    def _field_values(self, vals) -> dict:
        """{field: tensor value} of the candidate vector `vals`."""
        vals = torch.as_tensor(np.asarray(vals, dtype=np.float64),
                               device=self.device) \
            if not isinstance(vals, torch.Tensor) else vals.to(self.device)
        out = {}
        for j, key in enumerate(self.params_keys):
            v = (self.params_auxfuncs[j](vals)
                 if self.params_auxfuncs is not None else vals[j])
            out[key] = torch.as_tensor(v, device=self.device)
        return out

    def _candidate_params(self, vals):
        return self.params.replace(**self._field_values(vals))

    def _replay(self, pop, tracks: _Tracks):
        """Outputs [n, T, F] of the tracks' replay under the population
        params `pop` (row t = the state after t steps; row 0 the initial
        state, the reference's traj[:, :n] comparison,
        calibration.py:466-468). The last recorded step feeds no output,
        so T - 1 steps are taken."""
        state = tracks.state
        prep = getattr(self.model, "prepare", None)
        if prep is not None:
            state = prep(pop, state)
        hook = getattr(self.model, "step_constants", None)
        kw = hook(pop, F64, state.device) if hook is not None else {}
        steps = tracks.inputs.shape[1]
        out = torch.empty((tracks.n, steps, tracks.feats.numel()),
                          dtype=F64, device=state.device)
        out[:, 0] = state.s.index_select(1, tracks.feats)
        for t in range(steps - 1):
            ux, uy = tracks.inputs[:, t, 0], tracks.inputs[:, t, 1]
            if self.fix_speed:
                vfix = torch.sqrt(ux * ux + uy * uy)
                s = torch.cat([state.s[:, :V], vfix[:, None],
                               state.s[:, V + 1:]], dim=1)
                state = state.replace(s=s, dyn_v=vfix)
            state = self.model.step(pop, state, ux, uy, **kw)
            out[:, t + 1] = state.s.index_select(1, tracks.feats)
        return out

    def simulate(self, params, data: CalibrationData):
        """Replay all tracks of `data` under `params`; returns the outputs
        [K, T, F] (a float64 tensor on `device`) aligned with the
        objectives."""
        tracks = _Tracks(self, data)
        return self._replay(as_population(params, tracks.n, self.device),
                            tracks)

    def _objective(self, data: CalibrationData, vals):
        """The data set's replay (built at its first call, from `vals`)."""
        key = id(data)
        fn = self._replays.get(key)
        if fn is None:
            fn = self._replays[key] = _Replay(self, data, vals)
        return fn

    def objective(self, vals, test=False):
        data = self.test_data if test else self.train_data
        return float(self._objective(data, vals)(vals))

    def evaluate_population(self, candidates):
        """Errors [C] of a [C, P] candidate batch: one replay of the C x K
        riders, each candidate's fitted fields per-rider columns (the
        batched replacement for the reference's per-candidate Python
        re-simulation, calibration.py:438-460)."""
        cands = np.asarray(candidates, dtype=np.float64)
        c, k = cands.shape[0], len(self.train_data)
        tracks = _Tracks(self, self.train_data, copies=c)
        values = [self._field_values(v) for v in cands]
        cols = {key: torch.stack([v[key] for v in values]).repeat_interleave(
            k, dim=0) for key in self.params_keys}
        pop = as_population(self.params, tracks.n, self.device).replace(
            **cols)
        out = self._replay(pop, tracks)

        def per_candidate(a):
            return a.reshape((c, k) + a.shape[1:])

        errs = torch.func.vmap(self._err)(
            per_candidate(out), per_candidate(tracks.objectives),
            per_candidate(tracks.mask))
        return errs.cpu().numpy()

    # ---- optimize ----

    def run(self, guess):
        """Nelder-Mead from `guess` (reference run, calibration.py:472-526:
        scipy.optimize.fmin with maxiter)."""
        from scipy.optimize import fmin

        guess = np.asarray(guess, dtype=float)
        fn = self._objective(self.train_data, guess)

        def f(v):
            return float(fn(v))

        xopt, fopt, n_iter, n_calls, flag = fmin(
            f, guess, maxiter=self.maxiter, full_output=True,
            disp=self.verbose)
        self.result = {"x": xopt, "error": float(fopt), "iters": int(n_iter),
                       "calls": int(n_calls), "converged": flag == 0}
        if self.verbose:
            print(f"calibration: error={fopt:.6g} after {n_iter} "
                  f"iterations ({n_calls} evaluations)")
        return xopt, self.result

    def per_track_errors(self, vals=None, test=True):
        """Per-track errors over the valid steps, the calibration's error
        function applied track by track (the reference prints and plots
        per-test-sample results, calibration.py:528-623; this is the
        tabular half). For the shipped error functions the per-track
        values sum to the full objective. Returns (errors [K], outputs
        [K, T, F]) as numpy arrays."""
        data = self.test_data if test else self.train_data
        if data is None:
            raise ValueError("no test data")
        if vals is None:
            vals = self.result["x"]
        tracks = _Tracks(self, data)
        pop = as_population(self._candidate_params(vals), tracks.n,
                            self.device)
        out = self._replay(pop, tracks)
        errs = np.asarray([
            float(self._err(out[j:j + 1], tracks.objectives[j:j + 1],
                            tracks.mask[j:j + 1]))
            for j in range(len(data))])
        return errs, out.cpu().numpy()

    def test(self, vals=None, plot=False, color="blue", axes=None,
             name=None, plot_inref=True):
        """Error on the test partition for `vals` (default: the optimum),
        reference test (calibration.py:528-623).

        With `plot=True` it also draws the reference's result diagnostic
        (matplotlib, imported here) -- one subplot per test track with the
        measured objective (gray), the simulated trajectory under the
        calibrated parameters (`color`), and, for a heading objective with
        `plot_inref`, the input-force direction (gray dashed) -- and
        returns (error, figure). Heading features (state index 2) are
        shown in degrees relative to the track's initial heading, other
        features raw over the step index. `axes` (length K) plots into an
        existing figure."""
        if self.test_data is None:
            raise ValueError("no test data")
        if vals is None:
            vals = self.result["x"]
        # one replay serves the table, the total and the plot; for the
        # shipped additive error functions the per-track values sum to
        # the objective (a custom callable takes one objective() more)
        errs, out = self.per_track_errors(vals)
        err = (float(errs.sum()) if isinstance(self.error, str)
               else self.objective(vals, test=True))
        label = self.error if isinstance(self.error, str) else "error"
        if self.verbose:
            for j, e in enumerate(errs):
                print(f"    test track {j}: {label} {e:.4f} "
                      f"({int(self.test_data.lengths[j])} steps)")
            print(f"    {label}: {err:.4f}")
        if not plot:
            return err
        import matplotlib.pyplot as plt

        data = self.test_data
        k = len(data)
        feats = tuple(self.objective_features)
        if axes is None:
            fig, axes = plt.subplots(1, k, sharey=True, squeeze=False,
                                     figsize=(3 * k, 3))
            axes = axes[0]
        else:
            fig = axes[0].figure
        for j, ax in enumerate(axes[:k]):
            t = int(data.lengths[j])
            for fi, feat in enumerate(feats):
                if feat == 2:   # heading: degrees relative to psi_0
                    ref0 = float(data.s0[j, 2])
                    scale = 180.0 / np.pi
                    obj = (data.objectives[j, :t, fi] - ref0) * scale
                    sim = (out[j, :t, fi] - ref0) * scale
                    if plot_inref:
                        uin = data.inputs[j, :t]
                        ax.plot((np.arctan2(uin[:, 1], uin[:, 0]) - ref0)
                                * scale, color="gray", linestyle="--",
                                label="reference input" if fi == 0
                                else None)
                else:
                    obj = data.objectives[j, :t, fi]
                    sim = out[j, :t, fi]
                ax.plot(obj, color="gray",
                        label="measurement" if fi == 0 else None)
                ax.plot(sim, color=color,
                        label=name if fi == 0 else None)
            ax.set_title(f"track {j}")
            ax.set_xlabel("step")
        if name or plot_inref:
            axes[0].legend(fontsize=7)
        return err, fig
