"""Temporal graph service plane: ``DeltaStore`` promoted to a served
system.  A ``StorageCell`` owns one storage node's chunk/extent files
and serves them over a length-prefixed binary wire protocol
(``wire``); ``RemoteDeltaStore`` is a drop-in ``DeltaStore`` whose
nodes are cells reached over sockets — TGI, the PlanExecutor fetch
stage, and the decoded-block pool run unchanged on top of it.  An
append-only change feed per cell (``feed_since``) drives replica
catch-up after a crash.  Writers are lease-fenced: each holds a
time-bounded lease under a monotonic fencing epoch, stale-epoch writes
are rejected with the typed ``LeaseFenced``, dead writers' lanes are
sealed by orphan-seq reconciliation, and a writer that loses its cell
quorum degrades to read-only (``WriteUnavailable``) until it returns.
``LocalCluster`` spins up N cells x r replicas in threads or
subprocesses for tests, benches, and docs."""
from repro_torch.service.cell import FeedTruncated, StorageCell
from repro_torch.service.client import Backoff, RemoteDeltaStore
from repro_torch.service.cluster import ClusterSpec, LocalCluster
from repro_torch.service.wire import AuthFailed, LeaseFenced
from repro_torch.storage.kvstore import WriteUnavailable

__all__ = ["StorageCell", "RemoteDeltaStore", "ClusterSpec", "LocalCluster",
           "FeedTruncated", "LeaseFenced", "AuthFailed", "WriteUnavailable",
           "Backoff"]
