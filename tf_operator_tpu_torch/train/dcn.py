"""Cross-slice (DCN) collective channel for multislice training.

Counterpart of ``tf_operator_tpu/train/dcn.py``, whose channel and
framing this module copies. Each slice is its own ``torch.distributed``
world (one coordinator a slice, as the operator injects it); slice
leaders (in-slice rank 0) meet at ``MEGASCALE_COORDINATOR_ADDRESS`` and
allreduce over TCP, then broadcast the result to their in-slice peers
over the slice's own process group (``torch.distributed.broadcast`` from
rank 0, where JAX uses ``multihost_utils.broadcast_one_to_all``).

The wire format is JAX's: each message is a pickled object behind a
4-byte big-endian length, the arrays lists of f32 numpy arrays, and a
leader says hello with ``{"slice_id": i}``. A JAX leader and a port
leader therefore meet at one coordinator and reduce together.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import time
from typing import Any

import numpy as np

LOG = logging.getLogger(__name__)

_HDR = struct.Struct("!I")  # 4-byte big-endian frame length


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> Any:
    buf = b""
    while len(buf) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(buf))
        if not chunk:
            raise ConnectionError("DCN peer closed mid-header")
        buf += chunk
    (n,) = _HDR.unpack(buf)
    parts: list[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError("DCN peer closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    return pickle.loads(b"".join(parts))


class CrossSliceChannel:
    """Slice-leader rendezvous at the MEGASCALE coordinator address.

    Only in-slice process 0 of each slice takes part in the TCP leg;
    every process builds the channel (a non-leader's handle has no
    socket, and its :meth:`allreduce` raises: pair it with the in-slice
    broadcast of :func:`cross_slice_mean`).
    """

    def __init__(self, slice_id: int, num_slices: int,
                 coordinator_address: str, *, is_slice_leader: bool,
                 timeout: float = 120.0) -> None:
        self.slice_id = slice_id
        self.num_slices = num_slices
        self.is_slice_leader = is_slice_leader
        self._timeout = timeout
        self._listener: socket.socket | None = None
        self._peers: dict[int, socket.socket] = {}  # on slice 0
        self._sock: socket.socket | None = None  # on slices > 0
        if not is_slice_leader or num_slices < 2:
            return
        host, port_s = coordinator_address.rsplit(":", 1)
        port = int(port_s)
        if slice_id == 0:
            self._bind_and_accept(host, port)
        else:
            self._connect(host, port)

    def _bind_and_accept(self, host: str, port: int) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # The address names this pod; every interface is bound, so the
        # pod IP and a localhost rewrite both reach it.
        srv.bind(("", port))
        srv.listen(self.num_slices)
        srv.settimeout(self._timeout)
        self._listener = srv
        deadline = time.monotonic() + self._timeout
        while len(self._peers) < self.num_slices - 1:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"DCN rendezvous: {len(self._peers) + 1}/"
                    f"{self.num_slices} slices present at timeout")
            conn, _ = srv.accept()
            # accept() does not inherit the listener's timeout.
            conn.settimeout(self._timeout)
            hello = _recv_msg(conn)
            self._peers[int(hello["slice_id"])] = conn
        LOG.info("DCN rendezvous complete: %d slices", self.num_slices)

    def _connect(self, host: str, port: int) -> None:
        deadline = time.monotonic() + self._timeout
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.settimeout(self._timeout)
                _send_msg(sock, {"slice_id": self.slice_id})
                self._sock = sock
                return
            except OSError as e:  # the coordinator is not up yet
                last = e
                time.sleep(0.2)
        raise TimeoutError(
            f"DCN connect to {host}:{port} failed within budget: {last}")

    def allreduce(self, arrays: list[np.ndarray], op: str = "mean"
                  ) -> list[np.ndarray]:
        """Leader-side allreduce: slice 0 gathers, sums in slice order,
        divides for ``mean`` and fans the result back out."""
        if not self.is_slice_leader:
            raise RuntimeError("allreduce is leader-only; use cross_slice_mean")
        if self.num_slices < 2:
            return arrays
        if self.slice_id == 0:
            acc = [np.asarray(a, dtype=np.float32).copy() for a in arrays]
            for sid in sorted(self._peers):
                theirs = _recv_msg(self._peers[sid])
                for mine, other in zip(acc, theirs):
                    mine += other
            if op == "mean":
                for a in acc:
                    a /= self.num_slices
            for sid in sorted(self._peers):
                _send_msg(self._peers[sid], acc)
            return acc
        assert self._sock is not None
        _send_msg(self._sock, [np.asarray(a, dtype=np.float32)
                               for a in arrays])
        return _recv_msg(self._sock)

    def close(self) -> None:
        for sock in (*self._peers.values(), self._sock, self._listener):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self._peers.clear()
        self._sock = self._listener = None


def channel_from_env(env: dict[str, str] | None = None, *,
                     in_slice_process_id: int, timeout: float = 120.0
                     ) -> CrossSliceChannel | None:
    """The channel from the operator-injected MEGASCALE env (None for a
    single-slice job: there is no DCN leg)."""
    env = dict(os.environ if env is None else env)
    num_slices = int(env.get("MEGASCALE_NUM_SLICES", "1"))
    if num_slices < 2:
        return None
    return CrossSliceChannel(
        int(env.get("MEGASCALE_SLICE_ID", "0")), num_slices,
        env["MEGASCALE_COORDINATOR_ADDRESS"],
        is_slice_leader=in_slice_process_id == 0, timeout=timeout)


def _flatten(tree: Any) -> tuple[list, Any]:
    """Leaves of nested dicts, lists and tuples, and the spec
    ``_unflatten`` rebuilds the tree from."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", keys, [p[1] for p in parts], [len(p[0])
                                                       for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree), None, [p[1] for p in parts],
                 [len(p[0]) for p in parts]))
    return [tree], None


def _unflatten(spec: Any, leaves: list) -> Any:
    if spec is None:
        return leaves[0]
    kind, keys, subs, counts = spec
    out, at = [], 0
    for sub, n in zip(subs, counts):
        out.append(_unflatten(sub, leaves[at:at + n]))
        at += n
    if kind == "dict":
        return dict(zip(keys, out))
    return kind(out)


def cross_slice_mean(channel: CrossSliceChannel | None, tree: Any) -> Any:
    """Mean a tree of arrays or tensors across slices: the leaders'
    allreduce over DCN, then a broadcast from in-slice rank 0 over the
    slice's default process group (none for one process). No-op for a
    single-slice job (``channel`` None). Leaves come back as they went
    in: numpy arrays as f32 numpy arrays, tensors as tensors of their
    dtype on their device."""
    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch.train.distributed import collective_device

    if channel is None:
        return tree
    leaves, spec = _flatten(tree)
    host = [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in leaves]
    if channel.is_slice_leader:
        reduced = channel.allreduce(host)
    else:
        reduced = [np.zeros(h.shape, np.float32) for h in host]
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        on = collective_device()
        for i, r in enumerate(reduced):
            t = torch.from_numpy(np.ascontiguousarray(r, np.float32)).to(on)
            dist.broadcast(t, 0)
            reduced[i] = t.cpu().numpy()
    out = [torch.from_numpy(r).to(leaf.device, leaf.dtype)
           if isinstance(leaf, torch.Tensor) else np.asarray(r, np.float32)
           for leaf, r in zip(leaves, reduced)]
    return _unflatten(spec, out)
