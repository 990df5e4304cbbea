"""Canonical plan fingerprints (port of blaze_tpu/plan/fingerprint.py;
stdlib only).

A fingerprint is a blake2s digest over the canonical JSON form of an
engine-IR subtree (sorted keys, compact separators), so two submissions
of the same logical plan — regardless of dict insertion order — hash
identically, and the port's digests equal the JAX package's for the same
plan dict, string for string.  The statistics store (plan/statstore.py)
keys its records by them; adaptive execution (plan/adaptive.py) derives
a rewritten stage's identity from them.

The digest deliberately excludes the source data version.  The
reference's `source_snapshot` and `result_cache_key`, which version a
plan for its result and subplan caches, come with those caches (ROADMAP
item 16).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional


def _canonical(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def _digest(obj: Any) -> str:
    return hashlib.blake2s(_canonical(obj)).hexdigest()


def plan_fingerprint(plan: Dict[str, Any]) -> str:
    """Content digest of a whole IR (sub)tree; data-version agnostic."""
    return _digest(plan)


def subplan_fingerprint(stage_plan: Dict[str, Any],
                        partitioning: Optional[Dict[str, Any]],
                        num_tasks: int) -> str:
    """Identity of one exchange-producing map stage: the stage subtree
    plus the partitioning that shaped its shuffle output — two stages
    agreeing on both produce byte-identical partition blocks."""
    return _digest({"plan": stage_plan, "partitioning": partitioning,
                    "num_tasks": int(num_tasks)})


def derived_fingerprint(base_fp: str, rule: str,
                        params: Dict[str, Any]) -> str:
    """Fingerprint of an AQE-rewritten subtree: a digest over the
    ORIGINAL fingerprint plus the rewrite rule and its parameters.
    Derivation (rather than re-hashing the mutated IR, which embeds
    run-scoped resource ids) keeps the identity deterministic across
    runs while guaranteeing it can never collide with the static
    shape — so the statstore treats a rewritten stage as a distinct
    shape, never a stale hit."""
    return _digest({"base": base_fp, "rule": rule, "params": params})
