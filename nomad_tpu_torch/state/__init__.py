"""State layer (reference: nomad/state/ — StateStore over go-memdb).

A versioned in-memory store with snapshot-at-index semantics, secondary
indexes, watch hooks for the control loops, and an embedded ClusterMatrix
columnar mirror kept incrementally up to date (SURVEY.md section 2.7 item 7:
'state store hot reads -> host-side columnar mirror producing the dense
node x taskgroup matrices shipped to device').
"""

from nomad_tpu_torch.state.store import StateStore, StateSnapshot

__all__ = ["StateStore", "StateSnapshot"]
