"""The port's Server on YOLOv3's detection dict, the third task family
of the reference's serve smoke (tools/serve_smoke.py), served through
the JAX package's Server and the port's on the same weights and the
same seeded requests (tests/torch_serve_parity.py has the model,
weights and tolerances; the pose estimator and CenterNet are
tests/test_torch_serve_tasks.py).
"""
import pytest

from torch_serve_parity import Pair, check_nan_under_abort, check_rows


@pytest.fixture(scope="module", params=["yolo"])
def pair(request):
    return Pair(request.param)


def test_rows_agree_with_the_reference(pair, tmp_path):
    check_rows(pair, tmp_path)


def test_nan_request_fails_alike_under_abort(pair, tmp_path):
    check_nan_under_abort(pair, tmp_path)
