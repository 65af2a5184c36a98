"""The port's Server on the pose estimator and CenterNet, two task
families of the reference's serve smoke (tools/serve_smoke.py): the
pose estimator's bare (B, J, 3) keypoint tensor and CenterNet's
detection dict, each served through the JAX package's Server and the
port's on the same weights and the same seeded requests
(tests/torch_serve_parity.py has the models, weights and tolerances;
YOLOv3 is tests/test_torch_serve_tasks_yolo.py, a file of its own so
that each stays under 30 s alone).

The port's Server once took dict outputs only (`split_rows` and the
non-finite check read `.items()`), so every pose request failed; the
reference's `_split` and `_nonfinite_fields` take any output, leaf-wise,
and so does the port's now. Both pose cases fail on that router.
"""
import pytest

from torch_serve_parity import Pair, check_nan_under_abort, check_rows


@pytest.fixture(scope="module", params=["centernet", "pose"])
def pair(request):
    return Pair(request.param)


def test_rows_agree_with_the_reference(pair, tmp_path):
    check_rows(pair, tmp_path)


def test_nan_request_fails_alike_under_abort(pair, tmp_path):
    check_nan_under_abort(pair, tmp_path)
