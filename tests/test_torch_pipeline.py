"""The port's input pipeline (``data/pipeline.py``), mirroring the JAX
package's ``tests/test_pipeline_kvquant.py::TestPrefetcher``: the prefetched
stream equals direct synthesis (and the JAX package's batches, byte for
byte), a restore to an earlier step is served by direct synthesis, stale
entries drain, ``close()`` joins the worker, ``DevicePrefetcher`` places
tensors on the device it is given (with ``shardings``, only this data rank's
rows), and the port's ``Trainer`` runs on a
``Prefetcher``. CPU only; the card's side-stream copies are in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticC4 as JaxSyntheticC4
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DevicePrefetcher, Prefetcher
from repro_torch.data.synthetic import DataConfig, SyntheticC4
from repro_torch.optim.adam import AdamConfig
from repro_torch.parallel.sharding import LocalRows, ServingMesh, batch_shardings
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors are tiny, and under a loaded suite
    more threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_stream_matches_direct():
    src = SyntheticC4(DataConfig(100, 8, 2))
    want = JaxSyntheticC4(JaxDataConfig(100, 8, 2))
    pf = Prefetcher(src, depth=2)
    try:
        for step in range(4):
            got = pf.batch(step)
            np.testing.assert_array_equal(got["tokens"], src.batch(step)["tokens"])
            assert got["labels"].tobytes() == want.batch(step)["labels"].tobytes()
        assert next(pf)["tokens"].tobytes() == src.batch(4)["tokens"].tobytes()
    finally:
        pf.close()


def test_out_of_order_after_restore():
    """The stream runs ahead of a step the trainer asks for again (a restore
    to an earlier step): that step is synthesized directly; a later step
    drains the stale entries before it."""
    src = SyntheticC4(DataConfig(100, 8, 2, seed=3))
    pf = Prefetcher(src, start_step=5, depth=2)
    try:
        assert pf.batch(2)["tokens"].tobytes() == src.batch(2)["tokens"].tobytes()
        assert pf.batch(9)["tokens"].tobytes() == src.batch(9)["tokens"].tobytes()
        assert pf.batch(10)["tokens"].tobytes() == src.batch(10)["tokens"].tobytes()
    finally:
        pf.close()


@pytest.mark.parametrize("cls", [Prefetcher, DevicePrefetcher])
def test_close_joins(cls):
    kw = {"device": "cpu"} if cls is DevicePrefetcher else {}
    pf = cls(SyntheticC4(DataConfig(100, 8, 2)), depth=1, **kw)
    pf.batch(0)
    pf.close()
    assert not pf._thread.is_alive()


def test_device_prefetcher_places_tensors():
    src = SyntheticC4(DataConfig(100, 8, 2))
    pf = DevicePrefetcher(src, device="cpu", depth=1)
    try:
        for step in range(2):
            b = pf.batch(step)
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for v in b.values())
            assert torch.equal(b["tokens"], torch.from_numpy(src.batch(step)["tokens"]))
        b = pf.batch(0)                         # behind the stream: placed all the same
        assert isinstance(b["labels"], torch.Tensor)
    finally:
        pf.close()


@pytest.mark.parametrize("rows,index", [(2, 0), (2, 1), (3, 1)])
def test_device_prefetcher_places_this_ranks_rows(rows, index):
    """``shardings=batch_shardings(...)`` of a two-rank data mesh (data rank
    ``index`` of a stand-in grid: slicing needs no group) places that rank's
    rows of each batch, or the whole batch where the rows do not split, as a
    ``LocalRows`` naming the global row count."""
    src = SyntheticC4(DataConfig(100, 8, rows))
    mesh = ServingMesh(2, 1)
    mesh.data_index = index
    specs = batch_shardings(src.batch(0), mesh)
    split = rows % 2 == 0
    assert all(sh.spec == (("data" if split else None), None) for sh in specs.values())
    pf = DevicePrefetcher(src, shardings=specs, device="cpu", depth=1)
    try:
        for step in range(2):
            b = pf.batch(step)
            assert isinstance(b, LocalRows) and b.n == rows
            want = src.batch(step)["tokens"]
            want = want[index * rows // 2:(index + 1) * rows // 2] if split else want
            assert torch.equal(b["tokens"], torch.from_numpy(want))
    finally:
        pf.close()


def vanilla_fit(feed) -> list[float]:
    """The JAX test's run: 3 steps of the reduced Llama without SALAAD."""
    cfg = get_arch("salaad_llama_60m").reduced()
    tr = Trainer(cfg, TrainerConfig(total_steps=3, log_every=1, salaad=None,
                                    adam=AdamConfig(lr=1e-3)), device="cpu")
    state = tr.fit(tr.init(seed=0), feed, steps=3)
    assert state.step == 3
    return [m["loss"] for m in tr.metrics_log]


def source():
    return SyntheticC4(DataConfig(get_arch("salaad_llama_60m").reduced().vocab_size, 16, 4))


@pytest.fixture(scope="module")
def direct_losses():
    return vanilla_fit(source())


@pytest.mark.parametrize("cls", [Prefetcher, DevicePrefetcher])
def test_trainer_runs_on_prefetcher(cls, direct_losses):
    """The trainer fed through the queue gives the losses of a run on the
    source itself."""
    pf = cls(source(), **({"device": "cpu"} if cls is DevicePrefetcher else {}))
    try:
        assert vanilla_fit(pf) == direct_losses
    finally:
        pf.close()
