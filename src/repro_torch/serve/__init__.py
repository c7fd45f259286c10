"""repro_torch.serve — the batched MDRQ query server (synchronous window)."""
from repro_torch.serve.mdrq_server import MDRQServer, ServerStats, Ticket

__all__ = ["MDRQServer", "ServerStats", "Ticket"]
