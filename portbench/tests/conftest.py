import pytest

from portbench.tests.tiny import ANSWER_CELL, ANSWER_METRICS, bench_with


@pytest.fixture(scope="session")
def answer_bench(tmp_path_factory):
    """The benchmark with the answering cell's entry and metrics added."""
    return bench_with(tmp_path_factory.mktemp("answer"), [ANSWER_CELL],
                      ANSWER_METRICS)
