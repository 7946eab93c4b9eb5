"""Deterministic wire-fault injection at the query server's socket seams
(counterpart of hyperspace_tpu/interop/netfaults.py).

The storage fault injector (:mod:`hyperspace_tpu_torch.io.faults`) covers
every file and store seam; this module does the same for the network
between :class:`~hyperspace_tpu_torch.interop.server.QueryClient` and
:class:`~hyperspace_tpu_torch.interop.server.QueryServer`.  A killed
process fails cleanly (an RST on every socket); a real network fails
gray: connections hang, frames tear mid-stream, latency grows.

Four sites, armed like the store's (``faults.install`` or the conf's
``fault_injection_*`` fields, read when a session is made):

``net.connect``
    :func:`connect`, the client's dial.  ``refused`` raises
    ``ConnectionRefusedError``; ``reset`` (and ``torn-frame``) raises
    ``ConnectionResetError``; ``black-hole`` hangs ``hang_s`` and then
    raises ``TimeoutError``; ``slow`` dials ``latency_ms`` late.
``net.send``
    :func:`send_all`, a framed send: the client's request line, or the
    server's status line and Arrow stream while a wire plan is armed.
    ``torn-frame`` lands half the frame and then resets the connection,
    so the peer reads a truncated stream, never a clean EOF; ``reset``
    resets it before any byte; ``black-hole`` hangs and times out;
    ``slow`` delays and sends.
``net.recv``
    :func:`before_recv`, just before the client blocks on the response.
    The send side's kinds; a ``torn-frame`` here is a ``reset`` (tearing
    the bytes is the sender's part).
``net.accept``
    :func:`on_accept`, the server's accept in both IO modes.  ``reset``
    (and ``refused``, ``torn-frame``) resets the new connection;
    ``black-hole`` parks it open and silent, so only the client's own
    timeout saves it; ``slow`` passes.  It never blocks: the async IO
    mode's event loop calls it.

Every fault raises an ordinary ``OSError`` subclass, never
``InjectedCrash``: a wire fault is survivable, and the client maps it to
a retryable ``ConnectionError``.

Disarmed, a seam costs one ``is None`` check, and the server's response
path reaches none unless a wire plan is armed (:func:`armed` gates its
buffered detour).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.io import faults

# Sockets parked by a net.accept black-hole: held here so that the peer
# sees neither data nor a FIN (a dropped reference would close the socket
# and reset the client, the opposite of a partition).
_PARKED: List[socket.socket] = []


def armed() -> bool:
    """True when the armed plan names a net.* site: the gate of the
    server's buffered send, so the path with no wire plan never copies a
    whole frame."""
    plan = faults.active()
    return plan is not None and plan.site.startswith("net.")


def rst_close(sock: socket.socket) -> None:
    """Close with an RST instead of a FIN (SO_LINGER 0): the peer gets
    ``ECONNRESET`` mid-operation, as from a crashed host or a middlebox
    that dropped the flow."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def clear_parked() -> None:
    """Close every socket a black-hole parked (a test's teardown)."""
    while _PARKED:
        try:
            _PARKED.pop().close()
        except OSError:
            pass


def connect(address: Tuple[str, int],
            timeout: Optional[float] = None) -> socket.socket:
    """``socket.create_connection`` through the ``net.connect`` seam."""
    plan = faults.net("net.connect")
    if plan is not None:
        if plan.kind == "refused":
            raise ConnectionRefusedError(
                f"injected: connection refused dialing {address}")
        if plan.kind in ("reset", "torn-frame"):
            raise ConnectionResetError(
                f"injected: connection reset dialing {address}")
        if plan.kind == "black-hole":
            time.sleep(max(0.0, plan.hang_s))
            raise TimeoutError(
                f"injected: black-hole dialing {address} (hung "
                f"{plan.hang_s:.3f}s)")
        time.sleep(max(0.0, plan.latency_ms) / 1000.0)  # slow: late
    if timeout is not None:
        return socket.create_connection(address, timeout=timeout)
    return socket.create_connection(address)


def send_all(sock: socket.socket, data: bytes) -> None:
    """``sock.sendall(data)`` through the ``net.send`` seam.  A
    ``torn-frame`` lands exactly half the frame and then resets, so the
    peer's decoder sees a truncated stream, never a short valid one."""
    site = "net.send"
    plan = faults.net("net.send")
    if plan is None:
        sock.sendall(data)
        return
    if plan.kind == "slow":
        time.sleep(max(0.0, plan.latency_ms) / 1000.0)
        sock.sendall(data)
        return
    if plan.kind == "black-hole":
        time.sleep(max(0.0, plan.hang_s))
        raise TimeoutError(
            f"injected: black-hole at {site} (hung {plan.hang_s:.3f}s)")
    if plan.kind == "torn-frame":
        half = max(1, len(data) // 2)
        sock.sendall(data[:half])
        rst_close(sock)
        raise ConnectionResetError(
            f"injected: torn frame at {site}: {half}/{len(data)} bytes "
            f"landed, then RST")
    # reset, refused: the connection dies before a byte lands.
    rst_close(sock)
    raise ConnectionResetError(f"injected: connection reset at {site}")


def before_recv() -> None:
    """The client's read seam, just before it blocks on a response.
    ``slow`` delays the read; every failing kind raises what a dead or
    partitioned peer would."""
    site = "net.recv"
    plan = faults.net("net.recv")
    if plan is None:
        return
    if plan.kind == "slow":
        time.sleep(max(0.0, plan.latency_ms) / 1000.0)
        return
    if plan.kind == "black-hole":
        time.sleep(max(0.0, plan.hang_s))
        raise TimeoutError(
            f"injected: black-hole at {site} (hung {plan.hang_s:.3f}s)")
    raise ConnectionResetError(f"injected: connection reset at {site}")


def on_accept(sock: socket.socket) -> bool:
    """The server's accept seam (both IO modes).  False when the fault
    consumed the connection (reset or parked): the caller must not touch
    it again.  It never blocks: the async event loop calls it."""
    plan = faults.net("net.accept")
    if plan is None:
        return True
    if plan.kind in ("reset", "refused", "torn-frame"):
        rst_close(sock)
        return False
    if plan.kind == "black-hole":
        _PARKED.append(sock)  # open and silent: a partitioned server
        return False
    return True  # slow shapes the data path, not the accept
