"""CSI volume + plugin data model (reference nomad/structs/csi.go).

The claim lifecycle mirrors the reference's: a claim is taken when an
allocation using the volume is committed, moves through the release
states as the volume watcher unwinds it (unpublish -> node detach ->
controller detach -> released), and disappears from the claim maps when
released.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# access modes (csi.go CSIVolumeAccessMode*)
ACCESS_UNKNOWN = ""
ACCESS_SINGLE_READER = "single-node-reader-only"
ACCESS_SINGLE_WRITER = "single-node-writer"
ACCESS_MULTI_READER = "multi-node-reader-only"
ACCESS_MULTI_SINGLE_WRITER = "multi-node-single-writer"
ACCESS_MULTI_WRITER = "multi-node-multi-writer"

WRITE_MODES = (ACCESS_SINGLE_WRITER, ACCESS_MULTI_SINGLE_WRITER,
               ACCESS_MULTI_WRITER)

# attachment modes
ATTACH_UNKNOWN = ""
ATTACH_FILE_SYSTEM = "file-system"
ATTACH_BLOCK_DEVICE = "block-device"

# claim modes
CLAIM_READ = "read"
CLAIM_WRITE = "write"

# claim states (csi.go CSIVolumeClaimState*)
CLAIM_STATE_TAKEN = "taken"
CLAIM_STATE_NODE_DETACHED = "node-detached"
CLAIM_STATE_CONTROLLER_DETACHED = "controller-detached"
CLAIM_STATE_READY_TO_FREE = "ready-to-free"
CLAIM_STATE_UNPUBLISHING = "unpublishing"


@dataclass
class CSIVolumeClaim:
    """One allocation's claim on a volume (csi.go CSIVolumeClaim)."""
    alloc_id: str = ""
    node_id: str = ""
    mode: str = CLAIM_READ
    state: str = CLAIM_STATE_TAKEN


@dataclass
class CSIVolume:
    """Reference structs.CSIVolume (csi.go:300+), server-side record."""
    id: str = ""
    namespace: str = "default"
    name: str = ""
    external_id: str = ""
    plugin_id: str = ""
    provider: str = ""
    access_mode: str = ACCESS_UNKNOWN        # current mode (set by claims)
    attachment_mode: str = ATTACH_UNKNOWN
    requested_capabilities: List[Dict[str, str]] = field(default_factory=list)
    topologies: List[Dict[str, str]] = field(default_factory=list)
    capacity_min: int = 0
    capacity_max: int = 0
    # claims: alloc_id -> CSIVolumeClaim
    read_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    write_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    past_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    schedulable: bool = True
    resource_exhausted: float = 0.0          # unix ts; 0 = not exhausted
    controller_required: bool = False
    controllers_healthy: int = 0
    controllers_expected: int = 0
    nodes_healthy: int = 0
    nodes_expected: int = 0
    create_index: int = 0
    modify_index: int = 0

    # --------------------------------------------------- schedulability
    # csi.go:430-505

    def read_schedulable(self) -> bool:
        return self.schedulable and self.resource_exhausted == 0.0

    def write_schedulable(self) -> bool:
        if not (self.schedulable and self.resource_exhausted == 0.0):
            return False
        if self.access_mode in WRITE_MODES:
            return True
        if self.access_mode == ACCESS_UNKNOWN:
            return any(c.get("access_mode") in WRITE_MODES
                       for c in self.requested_capabilities) or \
                not self.requested_capabilities
        return False

    def has_free_read_claims(self) -> bool:
        if self.access_mode == ACCESS_SINGLE_READER:
            return len(self.read_claims) == 0
        if self.access_mode == ACCESS_SINGLE_WRITER:
            return not self.read_claims and not self.write_claims
        return True    # unknown or multi-node modes

    def has_free_write_claims(self) -> bool:
        if self.access_mode in (ACCESS_SINGLE_WRITER,
                                ACCESS_MULTI_SINGLE_WRITER):
            return len(self.write_claims) == 0
        if self.access_mode in (ACCESS_MULTI_WRITER, ACCESS_UNKNOWN):
            return True
        return False   # reader modes never have free write claims

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)

    # --------------------------------------------------------- claims

    def claim(self, c: CSIVolumeClaim) -> None:
        """Take a claim (csi.go ClaimRead/ClaimWrite): sets the access
        mode on first claim of an unknown-mode volume."""
        if c.mode == CLAIM_WRITE:
            if self.access_mode == ACCESS_UNKNOWN:
                self.access_mode = ACCESS_SINGLE_WRITER \
                    if not self.requested_capabilities else \
                    next((cap["access_mode"] for cap in
                          self.requested_capabilities
                          if cap.get("access_mode") in WRITE_MODES),
                         ACCESS_SINGLE_WRITER)
            self.write_claims[c.alloc_id] = c
            self.read_claims.pop(c.alloc_id, None)
        else:
            if self.access_mode == ACCESS_UNKNOWN:
                self.access_mode = ACCESS_MULTI_READER \
                    if not self.requested_capabilities else \
                    self.requested_capabilities[0].get(
                        "access_mode", ACCESS_MULTI_READER)
            self.read_claims[c.alloc_id] = c
        self.past_claims.pop(c.alloc_id, None)

    def release(self, alloc_id: str) -> None:
        """Fully release a claim; when the last claim drops, the volume
        returns to unknown access mode (csi.go ReleaseClaims)."""
        c = self.read_claims.pop(alloc_id, None) or \
            self.write_claims.pop(alloc_id, None)
        if c is not None:
            c.state = CLAIM_STATE_READY_TO_FREE
            self.past_claims[alloc_id] = c
        if not self.in_use():
            self.access_mode = ACCESS_UNKNOWN

    def stub(self) -> dict:
        return {
            "ID": self.id, "Namespace": self.namespace, "Name": self.name,
            "ExternalID": self.external_id, "PluginID": self.plugin_id,
            "Provider": self.provider, "AccessMode": self.access_mode,
            "AttachmentMode": self.attachment_mode,
            "CurrentReaders": len(self.read_claims),
            "CurrentWriters": len(self.write_claims),
            "Schedulable": self.schedulable,
            "ControllersHealthy": self.controllers_healthy,
            "ControllersExpected": self.controllers_expected,
            "NodesHealthy": self.nodes_healthy,
            "NodesExpected": self.nodes_expected,
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }


@dataclass
class CSIPlugin:
    """Aggregated plugin health, derived from node fingerprints
    (reference structs.CSIPlugin, maintained by state store node upserts).
    """
    id: str = ""
    provider: str = ""
    version: str = ""
    controller_required: bool = False
    # node_id -> {"healthy": bool, "max_volumes": int}
    controllers: Dict[str, dict] = field(default_factory=dict)
    nodes: Dict[str, dict] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    @property
    def controllers_healthy(self) -> int:
        return sum(1 for c in self.controllers.values() if c.get("healthy"))

    @property
    def nodes_healthy(self) -> int:
        return sum(1 for n in self.nodes.values() if n.get("healthy"))

    def stub(self) -> dict:
        return {
            "ID": self.id, "Provider": self.provider, "Version": self.version,
            "ControllerRequired": self.controller_required,
            "ControllersHealthy": self.controllers_healthy,
            "ControllersExpected": len(self.controllers),
            "NodesHealthy": self.nodes_healthy,
            "NodesExpected": len(self.nodes),
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }
