"""SUMO co-simulation demo.

Equivalent of the reference's demo/demoCSFxSUMO.py: cyclists ride a SUMO
network; on intersections they are simulated by the social-force engine.
Runs hermetically with the in-process FakeTraCI (no SUMO install needed);
`--net` takes a net.xml path or a packaged net name.

    python -m cyclistsocialforce_tpu_torch.demos.demo_sumo \\
        --bikes 8 --steps 4000
"""

import argparse

import numpy as np

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of

NET_XML = """<?xml version="1.0" encoding="UTF-8"?>
<net version="1.16">
  <edge id=":J_0" function="internal">
    <lane id=":J_0_0" index="0" speed="10" length="16"
          shape="-8.00,0.00 8.00,0.00"/>
  </edge>
  <edge id=":J_1" function="internal">
    <lane id=":J_1_0" index="0" speed="8" length="13.5"
          shape="0.00,-8.00 1.00,-4.00 4.00,-1.00 8.00,0.00"/>
  </edge>
  <edge id=":J_2" function="internal">
    <lane id=":J_2_0" index="0" speed="8" length="13.5"
          shape="-8.00,0.00 4.00,-1.00 1.00,-4.00 0.00,-8.00"/>
  </edge>
  <edge id="EW" from="JW" to="J" priority="1">
    <lane id="EW_0" index="0" speed="13.89" length="42"
          shape="-50.00,0.00 -8.00,0.00"/>
  </edge>
  <edge id="ES" from="JS" to="J" priority="1">
    <lane id="ES_0" index="0" speed="13.89" length="42"
          shape="0.00,-50.00 0.00,-8.00"/>
  </edge>
  <edge id="EE" from="J" to="JE" priority="1">
    <lane id="EE_0" index="0" speed="13.89" length="42"
          shape="8.00,0.00 50.00,0.00"/>
  </edge>
  <edge id="ESo" from="J" to="JS2" priority="1">
    <lane id="ESo_0" index="0" speed="13.89" length="42"
          shape="0.00,-8.00 0.00,-50.00"/>
  </edge>
  <junction id="J" type="priority" x="0" y="0"
            incLanes="EW_0 ES_0" intLanes=":J_0_0 :J_1_0 :J_2_0"
            shape="-8,2 8,2 8,-2 -8,-2"/>
  <junction id="JW" type="dead_end" x="-50" y="0" incLanes=""
            intLanes=""/>
  <junction id="JS" type="dead_end" x="0" y="-50" incLanes=""
            intLanes=""/>
  <junction id="JE" type="dead_end" x="50" y="0" incLanes="EE_0"
            intLanes=""/>
  <junction id="JS2" type="dead_end" x="0" y="-50" incLanes="ESo_0"
            intLanes=""/>
  <connection from="EW" to="EE" fromLane="0" toLane="0" via=":J_0_0"/>
  <connection from="ES" to="EE" fromLane="0" toLane="0" via=":J_1_0"/>
  <connection from="EW" to="ESo" fromLane="0" toLane="0" via=":J_2_0"/>
</net>
"""


def main(argv=None):
    from cyclistsocialforce_tpu_torch.sumo import (FakeTraCI,
                                                   SumoCoSimulation,
                                                   SumoNetwork)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bikes", type=int, default=6)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--bicycle-type", default="bicycle",
                    choices=["bicycle", "twowheeler", "invpendulum",
                             "balancingrider"])
    ap.add_argument("--net", default=None,
                    help="net.xml path, or a packaged net name "
                         "('threeleg', 'grid2x2')")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    if args.net in ("threeleg", "grid2x2"):
        from cyclistsocialforce_tpu_torch.sumo import load_packaged_net

        net = load_packaged_net(args.net)
    elif args.net:
        net = SumoNetwork.parse(args.net)
    else:
        net = SumoNetwork.parse(NET_XML)
    t = FakeTraCI(net, step_length=0.01)
    rng = np.random.default_rng(0)
    if args.net == "threeleg":
        routes = [("WJ", "JE"), ("SJ", "JE"), ("EJ", "JS"), ("SJ", "JW")]
    elif args.net == "grid2x2":
        routes = [("inA", "J00J10", "outA"), ("inB", "J10J11", "outB"),
                  ("inC", "J00J01", "outC"), ("inD", "J01J11", "outD")]
    else:
        routes = [("EW", "EE"), ("ES", "EE"), ("EW", "ESo")]
    for k in range(args.bikes):
        t.add_vehicle(f"bike{k}", routes[k % len(routes)],
                      speed=float(rng.uniform(3.0, 5.0)),
                      depart=float(k) * 1.5,
                      depart_pos=float(rng.uniform(0, 10)))

    cosim = SumoCoSimulation(net, t, bicycle_type=args.bicycle_type,
                             capacity=16, device=device)
    n = cosim.run(n_steps=args.steps)
    done = t.simulation.getMinExpectedNumber() == 0
    print(f"ran {n} steps; all vehicles finished: {done}")
    print(f"mean step wall time: "
          f"{1e3 * np.mean(cosim.hist_run_time):.2f} ms")


if __name__ == "__main__":
    main()
