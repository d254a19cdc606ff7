"""PyTorch port: the public callables that the port shares with the JAX
package take JAX's parameters in JAX's order, so that a call written for
the JAX package, positional arguments included, means the same in the
port. The port may add parameters only after JAX's (a `device`, a
`graph`).

Three faults of this kind were silent: `NeighborConfig(60.0, 128, 32)`
built kb 16 and block_src 32 in the port, `make_state(s0, 16, 128, None,
dtype, 3)` took the 3 as the model, and `Engine.create` had no
`sorted_resident` (bench.py:384-385's call raised TypeError) and took a
third positional argument as the destination force. Each has its
concrete case here besides the signature check that catches the class.
"""

import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import behavior as TB  # noqa: E402
from cyclistsocialforce_tpu_torch import calibration as TC  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import gmm_fit as TG  # noqa: E402
from cyclistsocialforce_tpu_torch import mixed as TM  # noqa: E402
from cyclistsocialforce_tpu_torch import params as TP  # noqa: E402
from cyclistsocialforce_tpu_torch import state as TS  # noqa: E402
from cyclistsocialforce_tpu_torch import sumo as TSU  # noqa: E402
from cyclistsocialforce_tpu_torch import viz as TV  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    from cyclistsocialforce_tpu import (behavior, calibration, engine,
                                        gmm_fit, mixed, params, state, sumo,
                                        viz)
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import hessbikerider

    return types.SimpleNamespace(JE=engine, JM=mixed, JP=params, JS=state,
                                 MODELS=JMODELS, hess=hessbikerider,
                                 JB=behavior, JC=calibration, JG=gmm_fit,
                                 JSU=sumo, JV=viz)


PORT = {"SU": TSU, "G": TG, "B": TB, "C": TC, "V": TV}


def _attr(module, dotted):
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def param_names(fn):
    return [name for name in inspect.signature(fn).parameters
            if name not in ("self", "cls")]


# name -> (the JAX package's callable, the port's), each from its modules
SHARED = {
    "NeighborConfig": lambda j: (j.JE.NeighborConfig, TE.NeighborConfig),
    "make_state": lambda j: (j.JS.make_state, TS.make_state),
    "set_destinations": lambda j: (j.JS.set_destinations,
                                   TS.set_destinations),
    "set_spline_destinations": lambda j: (j.JS.set_spline_destinations,
                                          TS.set_spline_destinations),
    "stop": lambda j: (j.JS.stop, TS.stop),
    "go": lambda j: (j.JS.go, TS.go),
    "Engine.create": lambda j: (j.JE.Engine.create, TE.Engine.create),
    "Engine.simulate": lambda j: (j.JE.Engine.simulate, TE.Engine.simulate),
    "Engine.step": lambda j: (j.JE.Engine.step, TE.Engine.step),
    "Engine.step_with_forces": lambda j: (j.JE.Engine.step_with_forces,
                                          TE.Engine.step_with_forces),
    "Engine.calc_forces": lambda j: (j.JE.Engine.calc_forces,
                                     TE.Engine.calc_forces),
    "Engine.repulsive_sum_neighbors": lambda j: (
        j.JE.Engine.repulsive_sum_neighbors,
        TE.Engine.repulsive_sum_neighbors),
    "Engine.repulsive_sum_neighbors_generic": lambda j: (
        j.JE.Engine.repulsive_sum_neighbors_generic,
        TE.Engine.repulsive_sum_neighbors_generic),
    "Engine.with_params": lambda j: (j.JE.Engine.with_params,
                                     TE.Engine.with_params),
    "MixedEngine.create": lambda j: (j.JM.MixedEngine.create,
                                     TM.MixedEngine.create),
    "MixedEngine.step": lambda j: (j.JM.MixedEngine.step,
                                   TM.MixedEngine.step),
    "MixedEngine.simulate": lambda j: (j.JM.MixedEngine.simulate,
                                       TM.MixedEngine.simulate),
    "ScriptedTraj.create": lambda j: (j.JE.ScriptedTraj.create,
                                      TE.ScriptedTraj.create),
    "as_population": lambda j: (j.JP.as_population, TP.as_population),
    "HessBikeRiderParams.create": lambda j: (
        j.hess.HessBikeRiderParams.create, TP.HessBikeRiderParams.create),
    **{f"{name}.create": (lambda name: lambda j: (
        getattr(j.JP, name).create, getattr(TP, name).create))(name)
       for name in ("VehicleParams", "CarParams", "BicycleParams",
                    "PlanarPointBicycleParams", "PlanarBicycleParams",
                    "InvPendulumBicycleParams", "BalancingRiderParams",
                    "RoadElementParams")},
    # the host-side layers: the JAX module's attribute of the same
    # dotted name as the port's
    **{f"{mod}.{name}": (lambda mod, name: lambda j: tuple(
        _attr(m, name) for m in (getattr(j, "J" + mod), PORT[mod])))(
            mod, name)
       for mod, names in {
           "SU": ("SumoCoSimulation", "SumoIntersection",
                  "SumoIntersection.add_road_user", "FakeTraCI",
                  "FakeTraCI.add_vehicle", "get_transport",
                  "SumoNetwork.parse", "SumoNetwork.lane_end_points",
                  "load_packaged_net"),
           "G": ("fit_gmm", "score_nll", "fit_optimize", "score_gmm",
                 "score_conditional_gmm", "n_parameters"),
           "B": ("GMMData.sample", "GMMData.marginal_pdf_2d",
                 "Preprocessing.fit", "PoleModel.import_from_yaml",
                 "PoleModel.export_to_yaml",
                 "PoleModel.sample_pole_features", "PoleModel.sample_poles",
                 "fit_pole_model", "combine_outliers"),
           "C": ("Calibration", "CalibrationData.split", "sse_timesteps",
                 "maesse_samples", "Calibration.simulate",
                 "Calibration.objective", "Calibration.evaluate_population",
                 "Calibration.run", "Calibration.per_track_errors",
                 "Calibration.test"),
           "V": ("SceneDrawing", "SceneDrawing.render", "animate",
                 "write_video", "plot_states", "plot_forces",
                 "eval_force_field", "plot_force_field",
                 "eval_potential_field", "density_map", "plot_density",
                 "plot_fft", "plot_gridsearch", "plot_marginals")}.items()
       for name in names},
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_jax_parameters_are_a_prefix_of_the_ports(jx, name):
    """JAX's parameter names, in order, open the port's."""
    jfn, tfn = SHARED[name](jx)
    want, got = param_names(jfn), param_names(tfn)
    assert got[:len(want)] == want, (
        f"{name}: the JAX package takes {want}, the port {got}")
    if "device" in got:
        assert got[-1] == "device", f"{name}: device is not last: {got}"


def test_neighbor_config_positional_arguments(jx):
    """`NeighborConfig(60.0, 128, 32)` is kb 32 in both packages (the port
    read block_src 32 and kept kb 16), and every JAX positional argument
    lands in the field of the same name."""
    args = (60.0, 128, 32)
    got, want = TE.NeighborConfig(*args), jx.JE.NeighborConfig(*args)
    assert (got.cutoff, got.block, got.kb, got.block_src) == (
        want.cutoff, want.block, want.kb, want.block_src) == (60.0, 128, 32,
                                                             128)
    full = (55.0, 128, 21, "pallas", 4, 1.5, 8.0, 0.02, 16, True,
            "flat", 64, 8, 2)
    got, want = TE.NeighborConfig(*full), jx.JE.NeighborConfig(*full)
    for f in ("cutoff", "block", "kb", "backend", "rebuild_every", "skin",
              "sub", "screen", "rebuild_mode", "block_src", "table_chunk",
              "row_segments"):
        assert getattr(got, f) == getattr(want, f), f


def test_neighbor_config_keeps_its_checks():
    """The reorder kept the dataclass frozen and its checks."""
    cfg = TE.NeighborConfig()
    with pytest.raises(Exception):
        cfg.kb = 3
    with pytest.raises(ValueError, match="block_src"):
        TE.NeighborConfig(60.0, 128, 16, block_src=48)
    with pytest.raises(ValueError, match="block_src != block"):
        TE.NeighborConfig(60.0, 128, 16, "pallas_db", block_src=64)
    assert TE.NeighborConfig(backend="xla").backend == "xla"


def test_make_state_positional_seed(jx):
    """`make_state(s0, 16, 128, None, dtype, 3)` keys the state [0, 3] in
    both packages (the port took the 3 as the model and keyed [0, 0])."""
    s0 = np.array([[0.0, 1.0, 0.2, 4.0], [3.0, -1.0, 0.1, 5.0]])
    got = TS.make_state(s0, 16, 128, None, torch.float64, 3, None, DEV)
    want = jx.JS.make_state(s0, 16, 128, None, np.float64, 3)
    np.testing.assert_array_equal(got.key.numpy(),
                                  np.asarray(want.key).astype(np.int64))
    assert got.key.tolist() == [0, 3]
    widths = TS.make_state(s0, 16, 8, None, torch.float64, 0,
                           MODELS["bicycle2d"], DEV)
    assert widths.dyn_x.shape == (2, 0) and widths.hist_len == 8


def test_engine_create_positional_road(jx):
    """`Engine.create(p, model, road)` takes the road, as in the JAX
    package (the port read it as the destination force)."""
    from cyclistsocialforce_tpu_torch.road import (build_road_elements,
                                                   straight_segment)

    road = build_road_elements([straight_segment((0, 0, 0), 4, 10)],
                               device=DEV)
    eng = TE.Engine.create(TP.BicycleParams.create(), MODELS["bicycle2d"],
                           road)
    assert eng.road is road
    assert eng.dest_force is TE.dest_force_straight


@pytest.mark.parametrize("sr", [None, True, False])
def test_bench_call_shape_constructs(jx, sr):
    """bench.py:384-385's `Engine.create(params, model, neighbors=cfg,
    sorted_resident=sr)` constructs in both packages (the port raised
    TypeError); None takes the model's SORTED_RESIDENT, True without
    one."""
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=19,
               rebuild_every=20)
    jeng = jx.JE.Engine.create(
        jx.JP.BicycleParams.create(), jx.MODELS["bicycle2d"],
        neighbors=jx.JE.NeighborConfig(**cfg), sorted_resident=sr)
    eng = TE.Engine.create(TP.BicycleParams.create(), MODELS["bicycle2d"],
                           neighbors=TE.NeighborConfig(**cfg),
                           sorted_resident=sr)
    assert eng.sorted_resident is (True if sr is None else sr)
    assert jeng.sorted_resident is eng.sorted_resident
    assert TE.Engine.create(TP.BicycleParams.create(), types.SimpleNamespace(
        step=MODELS["bicycle2d"].step, DEST_FORCE="straight",
        REP_FORCE="twod", SORTED_RESIDENT=False)).sorted_resident is False


def test_sorted_resident_false_runs_the_gather_loop(monkeypatch):
    """`sorted_resident=False` keeps the rows in their order: the chunks
    permute no state, and the run equals the sorted-resident one."""
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(512, 0.02, 8, 128, torch.float64, DEV)
    cfg = TE.NeighborConfig(cutoff=50.0, block=128, block_src=64, kb=24,
                            rebuild_every=5)

    def engine(sr):
        return TE.Engine.create(TP.BicycleParams.create(),
                                MODELS["bicycle2d"], rep_force="twod",
                                neighbors=cfg, sorted_resident=sr)

    want = engine(True).simulate(st, 12, record=False)[0]
    permuted = []
    real = TE.permute_state
    monkeypatch.setattr(TE, "permute_state",
                        lambda s, p: permuted.append(1) or real(s, p))
    got = engine(False).simulate(st, 12, record=False)[0]
    assert not permuted
    engine(True).simulate(st, 12, record=False)
    assert permuted
    np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), atol=1e-12)


def test_mixed_engine_step_takes_a_cache():
    """`MixedEngine.step(state, nbr_cache)` as the JAX package's."""
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(256, 0.02, 128, None, torch.float64, DEV)
    eng = TM.MixedEngine.create(
        [("bicycle2d", TP.BicycleParams.create(), 128),
         ("twod", TP.BicycleParams.create(), 128)],
        neighbors=TE.NeighborConfig(cutoff=100.0, block=128, block_src=64,
                                    kb=8))
    cache = eng.neighbor_cache(st)
    assert torch.equal(eng.step(st, cache).s, eng.step(st).s)
