"""A fabric head of the port in a subprocess, for the client-mode tests
(``python -m ray_lightning_tpu_torch.fabric.server --port 0``).

A reader thread owns the head's stdout: the boot wait has a real timeout
even if the head wedges before its ready line, and the pipe keeps
draining for the head's whole life, so neither it nor the workers sharing
its stdout can block on a full pipe. Stopping sends SIGINT (the head's
fabric session then kills every actor it spawned) and waits, bounded.
"""
import contextlib
import os
import queue
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def fabric_head(num_cpus: int = 8, boot_s: float = 60.0):
    """Yield ``(address, key)`` of a running head with ``num_cpus`` CPUs
    and no card; stop it afterwards."""
    env = dict(os.environ, RLT_NUM_GPUS="0")
    env.pop("RLT_REQUIRE_GPU", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_lightning_tpu_torch.fabric.server",
         "--port", "0", "--num-cpus", str(num_cpus)],
        env=env, stdout=subprocess.PIPE, text=True,
    )
    lines: "queue.Queue[str]" = queue.Queue()

    def _drain() -> None:
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=_drain, daemon=True).start()
    try:
        address = key = None
        deadline = time.monotonic() + boot_s
        while address is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("fabric head died during boot")
            try:
                line = lines.get(timeout=0.5)
            except queue.Empty:
                continue
            if line.startswith("FABRIC_SERVER_READY"):
                parts = line.split()
                address = parts[1]
                key = next((p[len("key="):] for p in parts[2:]
                            if p.startswith("key=")), None)
        assert address and key, "the head never printed its ready line"
        yield address, key
    finally:
        from ray_lightning_tpu_torch.fabric import client

        client.disconnect()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
