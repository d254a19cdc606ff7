"""Rider/bicycle dynamics models of the PyTorch port.

Each model module exposes ``N_STATES``, the default force names
``DEST_FORCE`` / ``REP_FORCE``, ``STATE_WIDTHS`` and
``step(params, state, fx, fy) -> state``, and may declare the hooks that
``Engine.create`` reads: ``step_constants``, ``clock_period`` and
``agent_kernels(params)``, the per-agent kernels its step takes
(``ops.agent_step.AgentKernels``, or None).
"""

from cyclistsocialforce_tpu_torch.models import (balancingrider, bicycle2d,
                                                 bicycle_twod, hessbikerider,
                                                 invpendulum, planarbicycle,
                                                 planarpoint)

MODELS = {
    "bicycle2d": bicycle2d,          # reference "planartwowheel" / Bicycle
    "twod": bicycle_twod,            # reference TwoDBicycle ("2D model")
    "planarpoint": planarpoint,      # reference PlanarPointBicycle
    "invpendulum": invpendulum,      # reference InvPendulumBicycle
    "balancingrider": balancingrider,  # reference BalancingRiderBicycle
    "planarbicycle": planarbicycle,  # reference PlanarBicycle
    "hessbikerider": hessbikerider,  # reference HessBikeRiderDynamics
    "hess": hessbikerider,           # the JAX package's name for it
}


def prepare(model, params, state):
    """Model-specific initialization of the state's dynamics latents (the
    reference's Dynamics.__init__ transforms): the model's own `prepare`
    where it has one; the state unchanged for bicycle2d and twod, which
    keep none."""
    fn = getattr(model, "prepare", None)
    return fn(params, state) if fn is not None else state


__all__ = ["MODELS", "prepare", "balancingrider", "bicycle2d",
           "bicycle_twod", "hessbikerider", "invpendulum", "planarbicycle",
           "planarpoint"]
