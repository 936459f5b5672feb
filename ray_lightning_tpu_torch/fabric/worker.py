"""Child-process entrypoint for fabric actors (PyTorch port of
``ray_lightning_tpu/fabric/worker.py``).

Spawned as ``python -m ray_lightning_tpu_torch.fabric.worker <socket-address>``
by the driver (NOT via multiprocessing.Process): a fresh interpreter that
never re-imports the user's ``__main__`` module and never inherits the
driver's CUDA context.

Environment overrides (``CUDA_VISIBLE_DEVICES`` for the cards the actor was
given, ``RLT_*`` switches) arrive via the process environment — set by the
driver *before* exec, hence before anything can import torch. The actor
class arrives as a cloudpickle blob over the connection.

Wire protocol (length-prefixed cloudpickle over a Connection):
  driver -> worker: ("init", blob)            instantiate actor class
                    ("call", call_id, blob)   run method, blob=(name, args, kw)
                    ("shutdown",)
  worker -> driver: ("ready", actor_repr)
                    ("result", call_id, ok, blob)  blob=value or (exc, tb_str)
                    ("shm", name, size)   any frame of SHM_FRAME_BYTES or
                                          more, parked in a shared-memory
                                          segment the driver unlinks
"""
import os
import sys
import traceback


#: Flipped once shutdown begins (normal loop exit or a first SIGTERM).
#: ``kill()`` SIGTERMs shortly after sending the "shutdown" message, so the
#: signal routinely lands while atexit is already running multiprocessing
#: manager finalizers — raising SystemExit there prints a traceback into
#: whatever captures stderr. Once exiting,
#: further SIGTERMs are no-ops.
_EXITING = False

#: Set by _worker_main: pushes one final ("heartbeat", {...,
#: "terminating": True}) frame so the driver can tell a CLEAN terminate
#: (this handler ran) from a heartbeat flatline (the process just
#: vanished). Best-effort: bounded lock wait, every failure swallowed —
#: a wedged connection must not stall the exit the signal asked for.
_TERM_NOTIFY = None

#: A frame to the driver at least this long travels through a shared-memory
#: segment, and the connection carries only its name: through the
#: connection a result of a gigabyte (a trained model's state stream) took
#: minutes on an H100 host. The driver's reader copies the frame out and
#: unlinks the segment as soon as it reads the name.
SHM_FRAME_BYTES = 1 << 20


def _on_sigterm(*_):
    global _EXITING
    if _EXITING or sys.is_finalizing():
        return
    _EXITING = True
    if _TERM_NOTIFY is not None:
        try:
            _TERM_NOTIFY()
        except Exception:  # noqa: BLE001 - exit anyway
            pass
    sys.exit(0)


def _install_unraisable_filter():
    """Silence the one benign unraisable: our SIGTERM SystemExit landing
    inside a finalizer/__del__ (e.g. a manager proxy's Finalize _decref
    mid-connection), where Python can only report-and-swallow it. The
    process still exits promptly — kill() sends the "shutdown" message
    before SIGTERM, so the actor loop breaks on its next recv (with
    SIGKILL escalation as the backstop). Everything else chains to the
    default hook."""
    default = sys.unraisablehook

    def hook(args):
        if args.exc_type is SystemExit and _EXITING:
            return
        default(args)

    sys.unraisablehook = hook


def _proc_stats():
    """Process-level stats for one heartbeat: rss, cpu time, uptime."""
    rss = 0
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            import resource

            # ru_maxrss is KiB on Linux — peak, not current; better than
            # nothing on non-procfs platforms.
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001
            pass
    times = os.times()
    return rss, times.user + times.system


def _heartbeat_loop(send, state, interval_s):
    """Daemon thread: push ("heartbeat", stats) to the driver every
    ``interval_s`` until the connection dies. The stats let the driver
    aggregate worker health (rss, cpu, last-call age) into its metrics
    registry without an RPC round trip — and without competing with a
    busy actor loop, which handles calls serially."""
    import time

    import cloudpickle

    while not _EXITING:
        time.sleep(interval_s)
        if _EXITING:
            return
        rss, cpu_s = _proc_stats()
        now = time.monotonic()
        stats = {
            "pid": os.getpid(),
            "rss_bytes": rss,
            "cpu_s": round(cpu_s, 3),
            "uptime_s": round(now - state["t0"], 3),
            "calls_handled": state["calls"],
            "calls_in_flight": state["busy"],
            "last_call_age_s": (
                None
                if state["last_end"] is None
                else round(now - state["last_end"], 3)
            ),
        }
        # Preemption notice piggybacks on the heartbeat: processes with
        # no RPC surface (gang followers) still reach the supervisor.
        # peek_state never CREATES a monitor — an unarmed process pays
        # one None check.
        try:
            from ray_lightning_tpu_torch.serve.preempt import peek_state

            p = peek_state()
            if p and p.get("pending"):
                stats["preempt"] = p
        except Exception:  # noqa: BLE001 - heartbeats must keep flowing
            pass
        try:
            send(cloudpickle.dumps(("heartbeat", stats)))
        except (OSError, ValueError):
            return  # driver gone; the main loop is exiting too


def _park(payload):
    """The ("shm", name, size) frame of a new segment holding ``payload``.
    The segment outlives this process: the driver unlinks it."""
    from multiprocessing import resource_tracker, shared_memory

    import cloudpickle

    shm = shared_memory.SharedMemory(create=True, size=len(payload))
    try:
        shm.buf[: len(payload)] = payload
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    shm.close()
    # This process's tracker would unlink the segment when it exits.
    resource_tracker.unregister("/" + shm.name.lstrip("/"), "shared_memory")
    return cloudpickle.dumps(("shm", shm.name, len(payload)))


def _unlink_parked(frame):
    from multiprocessing import shared_memory

    import cloudpickle

    try:
        shm = shared_memory.SharedMemory(name=cloudpickle.loads(frame)[1])
        shm.close()
        shm.unlink()
    except OSError:
        pass


def _send_frame(send, payload):
    """Send ``payload``, parked in shared memory when it is long; a parked
    frame that cannot be sent is unlinked here."""
    if len(payload) < SHM_FRAME_BYTES:
        send(payload)
        return
    frame = _park(payload)
    try:
        send(frame)
    except BaseException:
        _unlink_parked(frame)
        raise


def _worker_main(conn):
    """Run the actor loop. ``conn`` is an authenticated duplex Connection."""
    import signal
    import threading
    import time

    # SIGTERM (e.g. a tuner killing a trial actor) must run atexit so this
    # process's own fabric session shuts down any nested actors it spawned
    # (a trial's training workers) instead of orphaning them.
    signal.signal(signal.SIGTERM, _on_sigterm)
    _install_unraisable_filter()

    import cloudpickle  # cheap; imports no torch

    # Heartbeats share the connection with call results; serialize the
    # byte stream (interleaved send_bytes from two threads would corrupt
    # framing). RLT_HEARTBEAT_S <= 0 disables.
    send_lock = threading.Lock()

    def send(payload):
        with send_lock:
            conn.send_bytes(payload)

    hb_state = {"calls": 0, "busy": 0, "last_end": None, "t0": time.monotonic()}

    def _term_notify():
        """The final heartbeat a SIGTERM'd worker pushes before exiting:
        the driver reads ``terminating`` and classifies this death as a
        clean terminate, not a flatline. Lock wait is bounded — the
        heartbeat thread may be mid-send."""
        rss, cpu_s = _proc_stats()
        payload = cloudpickle.dumps((
            "heartbeat",
            {
                "pid": os.getpid(),
                "rss_bytes": rss,
                "cpu_s": round(cpu_s, 3),
                "uptime_s": round(time.monotonic() - hb_state["t0"], 3),
                "calls_handled": hb_state["calls"],
                "calls_in_flight": hb_state["busy"],
                "last_call_age_s": None,
                "terminating": True,
                "reason": "sigterm",
            },
        ))
        if send_lock.acquire(timeout=0.5):
            try:
                conn.send_bytes(payload)
            finally:
                send_lock.release()

    global _TERM_NOTIFY
    _TERM_NOTIFY = _term_notify
    try:
        hb_interval = float(os.environ.get("RLT_HEARTBEAT_S", "10"))
    except ValueError:
        hb_interval = 10.0
    if hb_interval > 0:
        threading.Thread(
            target=_heartbeat_loop,
            args=(send, hb_state, hb_interval),
            name="fabric-heartbeat",
            daemon=True,
        ).start()

    actor = None
    try:
        while True:
            try:
                msg = cloudpickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "shutdown":
                break
            if kind == "init":
                try:
                    cls, args, kwargs = cloudpickle.loads(msg[1])
                    actor = cls(*args, **kwargs)
                    send(cloudpickle.dumps(("ready", repr(type(actor)))))
                except BaseException as exc:  # noqa: BLE001 - report to driver
                    send(
                        cloudpickle.dumps(
                            ("ready_error", _exc_payload(exc))
                        )
                    )
                continue
            if kind == "call":
                call_id, blob = msg[1], msg[2]
                hb_state["busy"] = 1
                try:
                    name, args, kwargs = cloudpickle.loads(blob)
                    if actor is None:
                        raise RuntimeError("actor not initialized")
                    result = getattr(actor, name)(*args, **kwargs)
                    payload = cloudpickle.dumps(("result", call_id, True, result))
                except (SystemExit, KeyboardInterrupt):
                    # SIGTERM's sys.exit must propagate so the process exits
                    # promptly (running atexit -> nested-actor cleanup)
                    # instead of being reported as a call failure.
                    raise
                except BaseException as exc:  # noqa: BLE001 - ship to driver
                    payload = cloudpickle.dumps(
                        ("result", call_id, False, _exc_payload(exc))
                    )
                finally:
                    hb_state["busy"] = 0
                    hb_state["calls"] += 1
                    hb_state["last_end"] = time.monotonic()
                _send_frame(send, payload)
                continue
    finally:
        global _EXITING
        _EXITING = True  # late SIGTERMs (kill()'s follow-up) are no-ops now
        try:
            conn.close()
        except OSError:
            pass
        # Normal interpreter shutdown (atexit handlers run, letting the
        # CUDA runtime release the actor's context cleanly).
        sys.stdout.flush()
        sys.stderr.flush()


def _exc_payload(exc):
    tb = traceback.format_exc()
    try:
        import cloudpickle

        cloudpickle.dumps(exc)  # probe picklability
        return (exc, tb)
    except Exception:  # noqa: BLE001
        return (RuntimeError(f"{type(exc).__name__}: {exc}"), tb)


def main(argv) -> None:
    """``python -m ray_lightning_tpu_torch.fabric.worker <address>`` entrypoint.

    The connection authkey arrives on stdin (hex line) so it never shows in
    ``/proc/*/cmdline`` or the environment.
    """
    import multiprocessing as mp
    import time
    from multiprocessing.connection import Client

    # When this interpreter came up (wall clock): an actor reads it to
    # split its start-up into interpreter, imports and its own work.
    os.environ["RLT_WORKER_T0"] = repr(time.time())
    address = argv[1]
    authkey = bytes.fromhex(sys.stdin.readline().strip())
    mp_authkey = bytes.fromhex(sys.stdin.readline().strip())
    # Restore the driver's multiprocessing authkey (normally inherited by
    # mp children) so Manager/Queue proxies shipped from the driver
    # authenticate in this process and in any actors it nests.
    mp.current_process().authkey = mp_authkey
    conn = Client(address, authkey=authkey)
    _worker_main(conn)


if __name__ == "__main__":
    main(sys.argv)
