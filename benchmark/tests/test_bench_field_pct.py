"""The reader of `pair_field_pct` on a recorder's report made by hand."""

import pytest

from benchmark import harness


def ctx(counters, steps=1000):
    rep = {"steps": steps, "spans": {}, "counters": counters}
    return {"steps": 1000, "program_report": rep}


def read(c):
    return harness.load_reader("pair_field_pct").read(c)


def test_share_of_the_walked_pairs():
    c = ctx({"steps": 1000, "table_pairs": 8.9e10, "field_pairs": 4.0e10})
    assert read(c) == pytest.approx(100 * 4.0 / 8.9)
    assert read(ctx({"table_pairs": 10, "field_pairs": 0})) == 0.0


@pytest.mark.parametrize("counters", [
    {"table_pairs": 8.9e10},                    # a program without it
    {"field_pairs": 4.0e10},
    {"table_pairs": 0, "field_pairs": 0},
    {}])
def test_a_missing_counter_gives_nothing(counters):
    assert read(ctx(counters)) is None


def test_a_report_of_other_steps_gives_nothing():
    counters = {"table_pairs": 8.9e10, "field_pairs": 4.0e10}
    assert read(ctx(counters, steps=900)) is None
    assert read({"steps": 1000, "program_report": None}) is None
