"""Free-port discovery and the node address (PyTorch port of
``ray_lightning_tpu/utils/ports.py``).

``find_free_port`` feeds ``torch.distributed.init_process_group``'s
``tcp://host:port`` rendezvous, as the reference's feeds
``jax.distributed.initialize``.
"""
import contextlib
import socket


def find_free_port(host: str = "") -> int:
    """Bind port 0 on ``host`` and return the OS-assigned free port."""
    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def get_node_ip() -> str:
    """This host's address as the fabric's head node reports it.

    Every actor of the port's fabric runs on its head's host (a client in
    client mode spawns none of its own), so the loopback address is the
    node's address, and the rendezvous of workers on that host uses it.
    The reference resolves its routed address by connecting a UDP socket
    towards a public one; the port opens no socket towards another host.
    A client on another host reaches the head at the address its server
    was started with (``--host``).
    """
    return "127.0.0.1"
