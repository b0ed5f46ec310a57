"""The server on a mesh (``serve.py``: world rank 0 the front end, the other
ranks ``follow``) on one launch of two gloo CPU ranks on the (1, 1, 2)
mesh, over the tiny MagCache pipeline of ``tests/_torch_serving.py``
(``tests/_torch_mesh_ranks.py`` ``serve_run``, no JAX; rank 0's main
thread is the HTTP client): two unseeded requests within the window run as
one batch of two; a seeded request runs alone, resumes at step 4 from the
state the ranks left where the server looks for it, and its PNG is
bit-equal to the same request made through the mesh pipeline directly
(which ``test_torch_tp.py`` and ``test_torch_magcache.py`` hold against
JAX); a request at an unsupported size ends in ``error`` on every rank and
a later one ends ``done``; ``/healthz`` counts the ranks; stopping ends the
follower and the launch returns both ranks' results."""

import io

import numpy as np
import pytest

from kandinsky5_tpu_torch.parallel import launch

from . import _torch_mesh_ranks as ranks_mod


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return launch(ranks_mod.serve_run, 2, "gloo", "cpu",
                  args=(str(tmp_path_factory.mktemp("mesh_serve")),),
                  timeout=300)


def test_unseeded_requests_batch_on_the_mesh(served):
    """The two unseeded requests ran as one batch of two on both ranks."""
    lead, follower = served
    assert lead["after_pair"]["batches"] == 1
    assert lead["after_pair"]["batched_jobs"] == 2
    assert [r["ok"] for r in follower["records"]] == [True, True, False, True]
    assert follower["records"][0]["timings"]["steps"] == 6


def test_seeded_request_resumes_and_equals_the_direct_call(served):
    """The seeded request ran alone, resumed at step 4 of 6 from the state
    both ranks left (rank 0 wrote it, the server removed it), and its PNG
    is bit-equal to rank 0's frames of the direct mesh call."""
    from PIL import Image

    lead, follower = served
    st = lead["status"]["seeded"]
    assert st["state"] == "done" and st["start_step"] == 4
    assert follower["records"][1]["timings"]["start_step"] == 4
    served_png = np.asarray(Image.open(io.BytesIO(lead["png"])))
    assert lead["direct"].shape == (1, 1, 64, 64, 3)
    np.testing.assert_array_equal(served_png, lead["direct"][0, 0])
    assert follower["direct"] is None
    assert lead["files"] == []


def test_bad_request_fails_on_every_rank_and_the_server_goes_on(served):
    """The unsupported size raised its check on both ranks: the job ends in
    ``error``, the follower records it, and the later request is done."""
    lead, follower = served
    st = lead["status"]
    assert st["bad"]["state"] == "error" and "height, width" in \
        st["bad"]["error"]
    assert "height, width" in follower["records"][2]["error"]
    assert st["later"]["state"] == "done"
    assert all(st[k]["state"] == "done" for k in ("pair_a", "pair_b"))
    m = lead["metrics"]
    assert (m["jobs_done"], m["jobs_failed"], m["batches"]) == (4, 1, 3)


def test_healthz_and_stop(served):
    """``/healthz`` reports the mesh's two ranks; after the stop the
    follower returned its four batches, and the launch both results."""
    lead, follower = served
    assert lead["healthz"]["ok"] and lead["healthz"]["devices"] == 2
    assert (lead["rank"], follower["rank"]) == (0, 1)
    assert len(follower["records"]) == 4
