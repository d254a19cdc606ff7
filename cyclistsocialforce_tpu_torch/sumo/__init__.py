"""SUMO co-simulation subsystem of the port (counterpart of
`cyclistsocialforce_tpu.sumo`): a minimal net.xml model (`net`), a
transport multiplex over traci / libsumo / an in-process fake
(`transport`), and the co-simulation bridge that hands road users
between SUMO links and social-force intersections (`bridge`).
"""

from cyclistsocialforce_tpu_torch.sumo import bridge, net, transport
from cyclistsocialforce_tpu_torch.sumo.bridge import (SumoCoSimulation,
                                                      SumoIntersection)
from cyclistsocialforce_tpu_torch.sumo.net import (SumoNetwork,
                                                   load_packaged_net,
                                                   packaged_net_path)
from cyclistsocialforce_tpu_torch.sumo.transport import (FakeTraCI,
                                                         get_transport,
                                                         has_sumo)

__all__ = ["FakeTraCI", "SumoCoSimulation", "SumoIntersection",
           "SumoNetwork", "bridge", "get_transport", "has_sumo",
           "load_packaged_net", "net", "packaged_net_path", "transport"]
