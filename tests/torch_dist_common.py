"""Gloo ranks for the port's distributed tests, and the functions they run.

``RankPool(world)`` starts ``world`` Python processes, each with one torch
thread, in one gloo process group on this host (``tcp://127.0.0.1``), and
keeps them for the module that made it. ``pool.run(fn, *args)`` calls
``fn(*args)`` on every rank and returns the results in rank order; a rank's
exception is raised here with its traceback, and a call that takes longer
than its timeout kills the ranks and fails, so a hung rank fails its test
instead of hanging the run. ``fn`` must live in a module the ranks can
import: the functions below import torch, numpy and the port only.
"""

from __future__ import annotations

import importlib
import os
import secrets
import socket
import subprocess
import sys
import traceback
from functools import partial
from multiprocessing.connection import Client, Listener

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    def __init__(self, world: int, timeout: float = 120.0):
        self.world = world
        self.timeout = timeout
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        host, port = self._listener.address
        env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
        env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS]), OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(world), DSTPU_POOL=f"{host}:{port}:{key.hex()}")
        self._procs = [subprocess.Popen([sys.executable, "-c",
                                         "import torch_dist_common as c; c._worker()"],
                                        env={**env, "RANK": str(r)}, cwd=REPO)
                       for r in range(world)]
        self._conns = [None] * world
        self._listener._listener._socket.settimeout(timeout)
        try:
            for _ in range(world):
                conn = self._listener.accept()
                self._conns[conn.recv()] = conn
        except Exception:
            self.close()
            raise

    def run(self, fn, *args, timeout: float | None = None) -> list:
        for conn in self._conns:
            conn.send((fn.__module__, fn.__qualname__, args))
        out = []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout or self.timeout):
                self.close()
                raise TimeoutError(f"rank {rank} did not answer {fn.__qualname__} "
                                   f"within {timeout or self.timeout} s")
            status, value = conn.recv()
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {rank} failed in {fn.__qualname__}:\n{value}")
            out.append(value)
        return out

    def close(self) -> None:
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()


def _worker() -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    host, port, key = os.environ["DSTPU_POOL"].split(":")
    conn = Client((host, int(port)), authkey=bytes.fromhex(key))
    rank = int(os.environ["RANK"])
    conn.send(rank)
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    while True:
        msg = conn.recv()
        if msg is None:
            break
        module, name, args = msg
        try:
            fn = importlib.import_module(module)
            for part in name.split("."):
                fn = getattr(fn, part)
            conn.send(("ok", fn(*args)))
        except BaseException:  # noqa: BLE001 - the test reports it
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


# ------------------------------------------------ what the ranks run
def tiny_cfg(layers: int = 2):
    import dataclasses

    from deepspeed_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), num_layers=layers)


def build(config: dict, np_params=None, seed: int = 0, layers: int = 2):
    from deepspeed_tpu_torch.comm.topology import reset_topology
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.engine import initialize

    reset_topology()
    eng, _, _, _ = initialize(model=partial(llama.build, tiny_cfg(layers)), config=config,
                              initial_params=np_params, seed=seed, device="cpu")
    return eng


def full_state(eng) -> dict:
    """Full numpy params and moments (gathered), count and counters."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    names = tf.list_param_names(eng)
    out = {"params": {n: tf.safe_get_full_fp32_param(eng, n) for n in names}}
    fields = eng.opt_state._fields
    for field in ("mu", "nu", "trace"):
        if field in fields:
            out[field] = {n: tf.safe_get_full_optimizer_state(eng, n, field) for n in names}
    out["count"] = eng.opt_state.count if "count" in fields else None
    out["counters"] = (eng.global_steps, eng.global_samples, eng.micro_steps,
                       eng.skipped_steps)
    out["lr_scheduler"] = eng.lr_scheduler.state_dict()
    out["scale_state"] = {k: float(v) for k, v in eng.scale_state._asdict().items()}
    return out


def train(config: dict, np_params, batches: list) -> dict:
    """Train on ``batches``; the losses, grad norms and full final state."""
    eng = build(config, np_params)
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    out = {"losses": losses, "grad_norms": norms, **full_state(eng)}
    out["zero_stage"] = eng.zero_stage
    out["owned"] = {k: tuple(v.shape) for k, v in zip(eng._keys, eng._leaves)}
    eng.destroy()
    return out


def train_save_continue(config: dict, np_params, before: list, after: list,
                        save_dir: str, layers: int = 2) -> dict:
    """Train on ``before``, save, train on ``after``; losses of both."""
    eng = build(config, np_params, layers=layers)
    first = [float(eng.train_batch(b)) for b in before]
    path = eng.save_checkpoint(save_dir)
    rest = [float(eng.train_batch(b)) for b in after]
    eng.destroy()
    return {"before": first, "after": rest, "path": path}


def load_continue(config: dict, load_dir: str, after: list, seed: int = 9,
                  layers: int = 2) -> dict:
    """A fresh engine (other random weights) loads ``load_dir`` and trains on
    ``after``; the loaded state and the losses."""
    eng = build(config, None, seed=seed, layers=layers)
    path, client = eng.load_checkpoint(load_dir)
    state = full_state(eng)
    state["losses"] = [float(eng.train_batch(b)) for b in after]
    state["path"] = path
    eng.destroy()
    return state


FRAGMENT_CALLS = (("param", "layers/wq", None), ("state", "embed", "exp_avg"),
                  ("state", "layers/w_down", "nu"), ("state", "final_norm", "mu"))


def fragment_calls(tf, eng) -> dict:
    """``FRAGMENT_CALLS`` through either package's ``tensor_fragment`` module
    ``tf``, then its setter and getter: a full value in, the same value out."""
    out = {}
    for kind, name, state in FRAGMENT_CALLS:
        out[(kind, name, state)] = (tf.safe_get_full_fp32_param(eng, name) if kind == "param"
                                    else tf.safe_get_full_optimizer_state(eng, name, state))
    shape = out[("param", "layers/wq", None)].shape
    tf.safe_set_full_fp32_param(eng, "layers/wq",
                                np.arange(np.prod(shape), dtype=np.float32).reshape(shape))
    out["set_get"] = tf.safe_get_full_fp32_param(eng, "layers/wq")
    return out


def fragments_after_training(config: dict, np_params, bs: list) -> dict:
    """Train on ``bs``, then the port's ``tensor_fragment`` calls."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    eng = build(config, np_params)
    for b in bs:
        eng.train_batch(b)
    out = fragment_calls(tf, eng)
    out["grad"] = tf.safe_get_full_grad(eng, "embed")
    out["owned"] = tuple(eng.params["layers"]["wq"].shape)
    eng.destroy()
    return out


def batches(n: int, rows: int, seq: int, vocab: int, seed: int = 100) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, seq), dtype=np.int32)}
            for _ in range(n)]
