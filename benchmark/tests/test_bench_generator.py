import numpy as np

from benchmark import harness


def mix(**kw):
    base = harness.load_json(harness.BENCH / "traffic" / "district_8k.json")
    return {**base, **kw}


def test_same_seed_same_inputs_and_large_seeds():
    seed = 2 ** 31 + 12345
    a, b = harness.generate(mix(), seed), harness.generate(mix(), seed)
    assert np.array_equal(a["s0"], b["s0"])
    assert np.array_equal(a["dest"], b["dest"])
    c = harness.generate(mix(), seed + 1)
    assert not np.array_equal(a["s0"], c["s0"])


def test_sizes_and_ranges():
    m = mix(n_riders=1000, pad_to=128)
    x = harness.generate(m, 7)
    assert x["rows"] == 1024 and x["n_riders"] == 1000
    assert x["s0"].shape == (1024, 5) and x["dest"].shape == (1024, 2)
    half = 0.5 * np.sqrt(1000 / m["density_per_m2"])
    assert np.abs(x["s0"][:, :2]).max() <= half
    assert np.abs(x["dest"]).max() <= half
    assert x["s0"][:, 3].min() >= 1.0 and x["s0"][:, 3].max() <= 6.0
    assert np.abs(x["s0"][:, 2]).max() <= np.pi


def test_routes_ride_the_crowd_of_the_same_seed():
    routes = harness.load_json(harness.BENCH / "traffic" / "routes_100k.json")
    m = {**routes, "n_riders": 1000}
    seed = 2 ** 31 + 99
    x, crowd = harness.generate(m, seed), harness.generate(
        {**mix(), "n_riders": 1000}, seed)
    assert np.array_equal(x["s0"], crowd["s0"])
    again = harness.generate(m, seed)
    assert np.array_equal(x["waypoints"], again["waypoints"])
    k = m["waypoints_per_rider"]
    assert x["waypoints"].shape == (x["rows"], k, 2)
    assert np.array_equal(x["dest"], x["waypoints"][:, 0])
    # the k-th waypoint (k + 1) spacings along the route, at most the
    # side offset off it
    dist = np.linalg.norm(x["waypoints"] - x["s0"][:, None, :2], axis=2)
    along = m["waypoint_spacing_m"] * np.arange(1, k + 1)
    assert (dist >= along - 1e-9).all()
    assert (dist <= np.hypot(along, m["waypoint_side_m"]) + 1e-9).all()
