"""The cross-process maintenance lease (counterpart of
hyperspace_tpu/lifecycle/lease.py, its ``MaintenanceLease``): exactly one
daemon per system path executes maintenance.

One JSON record at ``<systemPath>/_hyperspace_lease/maintenance`` through
the LogStore seam's generation CAS (``put_if_generation_match``):

  ``{"v": 1, "holder": "<host>-<pid>-<start_ms>", "epoch": N,
     "acquired_at": ts, "expires_at": ts}``

  - Acquire: read the record and its generation; when it is absent,
    unparseable (a torn put) or past ``expires_at``, commit a fresh
    record with ``epoch + 1`` at that generation.  A lost CAS means
    another candidate won: stand by.
  - Renew: the holder commits a new ``expires_at`` against the
    generation of its own last commit.  A lost CAS means the lease was
    taken over while this process stalled: it is fenced and stops
    acting at once.  Its own expiry is also checked on its clock, so a
    holder that cannot reach the store stops after the TTL.
  - Store-latency margin: the holder times every store round trip (an
    EWMA) and treats its expiry as ``expires_at - margin`` (two round
    trips, clamped to [2% of the TTL, a third of it]), so a renew that
    stalls stops it before a successor may take over.
  - Release: a stopping holder commits the record back expired, so the
    next candidate takes over on its next poll.

Every acquire, takeover, renew, fence and release is a journal record of
decision ``lease`` (lifecycle/journal.py).

The record lives in the store ``conf.log_store_class`` names; the lease
reads it by point reads only, so a listing window does not delay it.
The ``lease.*`` counters (acquires, takeovers, conflicts, renews,
fenced, releases) are the JAX package's.

``WorkClaims`` is the same protocol over a SET of named work items, one
record per item (the multi-host build's chunk and bucket-group claims,
``parallel/multihost_build.py``): a done record is final, a takeover
bumps the item's epoch, and a fenced holder's ``complete`` loses the
CAS, so exactly one done record per item ever lands.  Its journal
records have decision ``claim``; its counters are ``claims.*``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from hyperspace_tpu_torch.telemetry import metrics
# The fleet plane's identity, so the lease holder, the build claims'
# holders and the heartbeat name one process alike.
from hyperspace_tpu_torch.telemetry.fleet import process_identity

LEASE_DIR = "_hyperspace_lease"
LEASE_KEY = "maintenance"
RECORD_VERSION = 1


def enabled(conf) -> bool:
    return bool(conf.lifecycle_lease_enabled)


def ttl_s(conf) -> float:
    return max(0.1, float(conf.lifecycle_lease_ttl_s))


def lease_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), LEASE_DIR)


def _store(conf):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, lease_root(conf))


def _parse(payload: Optional[bytes]) -> Optional[Dict[str, Any]]:
    if not payload:
        return None
    try:
        rec = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None  # a torn put burned the key: up for grabs
    return rec if isinstance(rec, dict) else None


def status(conf) -> Optional[Dict[str, Any]]:
    """The current lease record with ``fresh`` (not yet expired), or None
    when it is absent or unreadable.  Never raises."""
    try:
        payload, _gen = _store(conf).read_with_generation(LEASE_KEY)
    except Exception:  # noqa: BLE001 - an unreadable lease reads absent
        return None
    rec = _parse(payload)
    if rec is None:
        return None
    rec = dict(rec)
    rec["fresh"] = float(rec.get("expires_at", 0.0)) > time.time()
    return rec


class MaintenanceLease:
    """One process's handle on the maintenance lease.  A store failure
    never raises out of ``ensure``: it parks the daemon for a cycle."""

    def __init__(self, conf, owner: Optional[str] = None) -> None:
        self.conf = conf
        self.owner = owner or process_identity()
        self.epoch = 0
        self._held = False
        self._gen = 0            # generation of our last committed record
        self._expires_at = 0.0   # our expiry on our own clock
        self._lat_ewma_s = 0.0   # the store round trip's EWMA

    def margin_s(self) -> float:
        """How long before its expiry this holder stops acting."""
        ttl = ttl_s(self.conf)
        return min(ttl / 3.0, max(2.0 * self._lat_ewma_s, 0.02 * ttl))

    def holds(self) -> bool:
        """Held, and not within ``margin_s`` of our own expiry."""
        return self._held and \
            time.time() < self._expires_at - self.margin_s()

    def _observe_latency(self, elapsed_s: float) -> None:
        self._lat_ewma_s = elapsed_s if self._lat_ewma_s <= 0.0 \
            else 0.7 * self._lat_ewma_s + 0.3 * elapsed_s

    def ensure(self) -> bool:
        """Each cycle's entry: renew when holding, else try to acquire.
        True iff this process may execute maintenance."""
        try:
            if self._held:
                return self.renew()
            return self.try_acquire()
        except Exception as e:  # noqa: BLE001 - parks the daemon a cycle
            self._note("error", outcome="error", error=str(e))
            self._held = False
            return False

    def try_acquire(self) -> bool:
        store = _store(self.conf)
        t0 = time.monotonic()
        payload, gen = store.read_with_generation(LEASE_KEY)
        self._observe_latency(time.monotonic() - t0)
        rec = _parse(payload)
        now = time.time()
        if rec is not None and float(rec.get("expires_at", 0.0)) > now:
            return False  # a live holder: stand by
        prior_epoch = int(rec.get("epoch", 0)) if rec is not None else 0
        takeover = rec is not None
        t0 = time.monotonic()
        committed = store.put_if_generation_match(
            LEASE_KEY, self._record(prior_epoch + 1, now), gen)
        self._observe_latency(time.monotonic() - t0)
        if not committed:
            metrics.inc("lease.conflicts")
            return False  # another candidate won this round
        self.epoch = prior_epoch + 1
        self._held = True
        self._gen = gen + 1
        self._expires_at = now + ttl_s(self.conf)
        metrics.inc("lease.acquires")
        if takeover:
            metrics.inc("lease.takeovers")
            self._note("takeover",
                       reason=f"expired lease epoch {prior_epoch} "
                              f"(holder {rec.get('holder', '?')}) taken "
                              f"over as epoch {self.epoch}")
        else:
            self._note("acquire", reason=f"fresh lease, epoch {self.epoch}")
        return True

    def renew(self) -> bool:
        if not self._held:
            return False
        store = _store(self.conf)
        now = time.time()
        t0 = time.monotonic()
        renewed = store.put_if_generation_match(
            LEASE_KEY, self._record(self.epoch, now), self._gen)
        self._observe_latency(time.monotonic() - t0)
        if renewed:
            self._gen += 1
            self._expires_at = now + ttl_s(self.conf)
            metrics.inc("lease.renews")
            self._note("renew", reason=f"epoch {self.epoch}")
            return True
        # Lost the CAS: the lease moved while this process stalled.
        self._held = False
        self._gen = 0
        metrics.inc("lease.fenced")
        self._note("fence", outcome="error",
                   reason=f"renew lost the CAS at epoch {self.epoch}; "
                          f"lease taken over — standing down")
        return False

    def release(self) -> None:
        """Commit the record back expired, so the next candidate takes
        over on its next poll; the TTL is the backstop if this fails."""
        if not self._held:
            return
        try:
            store = _store(self.conf)
            rec = json.loads(self._record(self.epoch, time.time()))
            rec["expires_at"] = 0.0
            store.put_if_generation_match(
                LEASE_KEY, json.dumps(rec).encode("utf-8"), self._gen)
            metrics.inc("lease.releases")
            self._note("release", reason=f"epoch {self.epoch} released")
        except Exception as e:  # noqa: BLE001 - best effort
            self._note("error", outcome="error", error=str(e))
        finally:
            self._held = False
            self._gen = 0

    def _record(self, epoch: int, now: float) -> bytes:
        return json.dumps({
            "v": RECORD_VERSION,
            "holder": self.owner,
            "epoch": epoch,
            "acquired_at": now,
            "expires_at": now + ttl_s(self.conf),
        }).encode("utf-8")

    def _note(self, event: str, reason: str = "", outcome: str = "done",
              error: str = "") -> None:
        from hyperspace_tpu_torch.lifecycle import journal

        rec = {
            "decision": "lease",
            "index": "",
            "mode": event,
            "reason": reason,
            "outcome": outcome,
            "holder": self.owner,
            "epoch": self.epoch,
        }
        if error:
            rec["error"] = error[:500]
        journal.append(self.conf, rec)


class WorkClaims:
    """A crash-recoverable claim table: the lease's TTL and epoch fencing
    per named work item.

    One JSON record per item at ``<store root>/claim-<item>`` (flat keys:
    both store classes list one level):

      pending: ``{"v": 1, "item", "holder", "epoch", "acquired_at",
                  "expires_at", "done": false}``
      done:    ``{"v": 1, "item", "holder", "epoch", "done": true,
                  "acquired_at", "completed_at", "result": {...}}``

      - ``try_claim`` commits a fresh record over an absent, torn or
        expired pending one (the epoch bumped on a takeover); a done
        record is final and never taken.
      - ``renew`` commits against the holder's own last generation; a
        lost CAS means the item was taken while this process stalled:
        it is fenced and drops its work.
      - ``complete`` commits the done record through the same CAS, so a
        fenced holder's completion loses and one done record per item
        lands.
      - ``holds`` keeps the store-latency margin: a holder stands down
        ``margin_s`` before its expiry on its own clock.

    Acquire, reclaim, fence and complete are journal records of decision
    ``claim``, with the item and the epoch."""

    PREFIX = "claim-"

    def __init__(self, store, conf, owner: Optional[str] = None,
                 ttl_s: float = 10.0, index: str = "") -> None:
        self.store = store
        self.conf = conf
        self.owner = owner or process_identity()
        self.ttl_s = max(0.1, float(ttl_s))
        self.index = index
        self._lat_ewma_s = 0.0

    def margin_s(self) -> float:
        """Two measured store round trips, clamped to [2% of the TTL, a
        third of it], as :meth:`MaintenanceLease.margin_s`."""
        return min(self.ttl_s / 3.0,
                   max(2.0 * self._lat_ewma_s, 0.02 * self.ttl_s))

    def holds(self, claim: Dict[str, Any]) -> bool:
        """The claim is still safely ours: not within ``margin_s`` of its
        expiry on our clock."""
        return time.time() < \
            float(claim.get("expires_at", 0.0)) - self.margin_s()

    def _observe_latency(self, elapsed_s: float) -> None:
        self._lat_ewma_s = elapsed_s if self._lat_ewma_s <= 0.0 \
            else 0.7 * self._lat_ewma_s + 0.3 * elapsed_s

    def _key(self, item: str) -> str:
        return self.PREFIX + item

    def get(self, item: str):
        """(record or None, generation): a torn put reads as None with
        the generation it burned, so a reclaim commits over it."""
        t0 = time.monotonic()
        payload, gen = self.store.read_with_generation(self._key(item))
        self._observe_latency(time.monotonic() - t0)
        return _parse(payload), gen

    def result(self, item: str) -> Optional[Dict[str, Any]]:
        """A done item's result, or None while it is pending."""
        rec, _gen = self.get(item)
        if rec is not None and rec.get("done"):
            return rec.get("result", {})
        return None

    def pending(self, items) -> list:
        """The items with no done record yet."""
        return [it for it in items if self.result(it) is None]

    def _put(self, item: str, body: Dict[str, Any], gen: int) -> bool:
        t0 = time.monotonic()
        committed = self.store.put_if_generation_match(
            self._key(item), json.dumps(body).encode("utf-8"), gen)
        self._observe_latency(time.monotonic() - t0)
        return committed

    def try_claim(self, item: str) -> Optional[Dict[str, Any]]:
        """Claim ``item`` when it is absent, torn or expired.  Returns the
        handle ``{"item", "epoch", "gen", "acquired_at", "expires_at"}``
        that ``renew`` and ``complete`` take, or None (done, a live
        holder, or a lost CAS)."""
        rec, gen = self.get(item)
        now = time.time()
        if rec is not None:
            if rec.get("done"):
                return None
            if float(rec.get("expires_at", 0.0)) > now:
                return None
        # A torn record hides its epoch; every commit bumps the generation
        # by at least one, so gen + 1 passes any epoch it could carry.
        prior_epoch = int(rec.get("epoch", gen)) if rec is not None else gen
        epoch = prior_epoch + 1
        if not self._put(item, {
                "v": RECORD_VERSION, "item": item, "holder": self.owner,
                "epoch": epoch, "acquired_at": now,
                "expires_at": now + self.ttl_s, "done": False}, gen):
            metrics.inc("claims.conflicts")
            return None
        claim = {"item": item, "epoch": epoch, "gen": gen + 1,
                 "acquired_at": now, "expires_at": now + self.ttl_s}
        if rec is not None or gen:
            metrics.inc("claims.reclaims")
            holder = rec.get("holder", "?") if rec is not None else "?"
            self._note("reclaim", item, epoch,
                       reason=f"expired/torn claim (holder {holder}) "
                              f"taken over as epoch {epoch}")
        else:
            metrics.inc("claims.acquires")
            self._note("acquire", item, epoch,
                       reason=f"fresh claim, epoch {epoch}")
        return claim

    def renew(self, claim: Dict[str, Any]) -> bool:
        """Extend the claim; False means fenced (taken under us): the
        caller drops the item's work at once."""
        now = time.time()
        if self._put(claim["item"], {
                "v": RECORD_VERSION, "item": claim["item"],
                "holder": self.owner, "epoch": claim["epoch"],
                "acquired_at": now, "expires_at": now + self.ttl_s,
                "done": False}, claim["gen"]):
            claim["gen"] += 1
            claim["expires_at"] = now + self.ttl_s
            return True
        metrics.inc("claims.fenced")
        self._note("fence", claim["item"], claim["epoch"], outcome="error",
                   reason=f"renew lost the CAS at epoch {claim['epoch']}; "
                          f"claim reclaimed — standing down")
        return False

    def complete(self, claim: Dict[str, Any],
                 result: Optional[Dict[str, Any]] = None) -> bool:
        """Commit the done record through the claim's CAS.  False means
        fenced: another holder took the item, and this one's output is
        discarded."""
        if self._put(claim["item"], {
                "v": RECORD_VERSION, "item": claim["item"],
                "holder": self.owner, "epoch": claim["epoch"], "done": True,
                "acquired_at": claim.get("acquired_at", 0.0),
                "completed_at": time.time(), "result": result or {}},
                claim["gen"]):
            claim["gen"] += 1
            metrics.inc("claims.completes")
            self._note("complete", claim["item"], claim["epoch"],
                       reason=f"epoch {claim['epoch']} done")
            return True
        metrics.inc("claims.fenced")
        self._note("fence", claim["item"], claim["epoch"], outcome="error",
                   reason=f"complete lost the CAS at epoch "
                          f"{claim['epoch']}; output discarded")
        return False

    def _note(self, event: str, item: str, epoch: int, reason: str = "",
              outcome: str = "done") -> None:
        from hyperspace_tpu_torch.lifecycle import journal

        journal.append(self.conf, {
            "decision": "claim",
            "index": self.index,
            "mode": event,
            "reason": reason,
            "outcome": outcome,
            "holder": self.owner,
            "epoch": epoch,
            "item": item,
        })
