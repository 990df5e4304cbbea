"""BASELINE config #5's breadth, group 'c' of
test_torch_breadth_a.py's `GROUPS`: each query function gives the JAX
package's plan dict, and its run through the port's stage DAG equals its
pandas oracle (as a set) and the JAX DagScheduler (rows in order, every
map output's bytes).  Data, routes and tolerance as in
test_torch_breadth_a.py: scale 0.01, 2 files a table, 2 exchange
partitions; floats within 1e-9 relative, the rest exact."""

import pytest

from test_torch_breadth_a import (GROUPS, breadth_data, breadth_runs,
                                  check_plan_dict, check_map_bytes,
                                  check_query, confs)  # noqa: F401

NAMES = GROUPS["c"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return breadth_data(tmp_path_factory, NAMES)


@pytest.fixture(scope="module")
def runs(data):
    return breadth_runs(data, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_plan_dict_is_the_reference_one(data, name):
    check_plan_dict(data, name)


@pytest.mark.parametrize("name", NAMES)
def test_query_equals_the_oracle_and_the_jax_scheduler(data, runs, name):
    check_query(data, runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_map_outputs_are_the_jax_bytes(data, runs, name, tmp_path):
    check_map_bytes(data, runs, name, tmp_path)
