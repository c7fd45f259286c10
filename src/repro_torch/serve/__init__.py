"""repro_torch.serve — the batched MDRQ query server (synchronous window),
its pipelined variant (overlapped device and finalize stages), and the LM's
decode step and continuous batcher with MDRQ admission."""
from repro_torch.serve.batching import BatchServer, Request, admission_query
from repro_torch.serve.mdrq_server import MDRQServer, ServerStats, Ticket
from repro_torch.serve.pipeline import (Overloaded, PipelinedMDRQServer,
                                        PipelineTicket, WarmupReport,
                                        serve_pipelined)
from repro_torch.serve.serve_step import greedy_sample, make_serve_step

__all__ = ["MDRQServer", "ServerStats", "Ticket", "BatchServer", "Request",
           "admission_query", "greedy_sample", "make_serve_step",
           "Overloaded", "PipelinedMDRQServer", "PipelineTicket",
           "WarmupReport", "serve_pipelined"]
