"""The hybrid control plane: endpoints announced and discovered over MQTT.

Port of ``nnstreamer_tpu/distributed/hybrid.py`` (≙ the reference's
nnstreamer-edge HYBRID connect type: control over MQTT, data direct,
``CHANGES:8-13``), shared by the edge elements (one retained announce per
topic) and the tensor_query elements (one retained announce per server
instance under ``nns/query/<topic>/``, discovered by wildcard).

An announce is a RETAINED JSON object carrying at least ``{"host",
"port"}``; publishing an empty retained payload on its topic deletes it
(MQTT 3.3.1.3).  Publishes are QoS 1 and waited for, so "announced" implies
"discoverable".  A crashed server never deletes its announce:
:func:`probe_endpoint` lets discoverers skip an endpoint that no longer
accepts.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

from ..core.log import get_logger
from .mqtt import MqttClient

log = get_logger("hybrid")


class Announcement:
    """A live retained announce; ``clear()`` deletes it.  On every reconnect
    of its client (a restarted broker forgot its retained messages, a
    failed-over standby never had them) the current announce is published
    again, counted in ``reannounces``."""

    def __init__(self, broker_host: str, broker_port: int, topic: str, info: dict,
                 logger=None, brokers: Optional[Iterable[Tuple[str, int]]] = None):
        self.topic = topic
        self.log = logger or log
        self.info = dict(info)
        # update() runs on element threads, _reannounce on the MQTT reader
        self._lock = threading.Lock()
        self.reannounces = 0
        self._client: Optional[MqttClient] = MqttClient(broker_host, broker_port, brokers=brokers)
        self._client.on_connect(self._reannounce)
        self._client.publish(topic, json.dumps(self.info).encode(), retain=True, qos=1)
        if self._client.drain(5.0):
            self.log.warning("endpoint announce on %s unacknowledged by the broker", topic)

    @property
    def connected(self) -> bool:
        client = self._client
        return client is not None and client.connected.is_set()

    @property
    def reconnects(self) -> int:
        client = self._client
        return client.reconnects if client is not None else 0

    def _reannounce(self) -> None:
        client = self._client
        if client is None:
            return
        with self._lock:
            payload = json.dumps(self.info).encode()
            self.reannounces += 1
        try:
            client.publish(self.topic, payload, retain=True, qos=1)
        except OSError:
            pass  # the link flapped again: the next reconnect publishes

    def update(self, patch: dict, wait_ack: bool = True, require_connected: bool = False) -> None:
        """Merge ``patch`` into the announce and publish it again: the plane
        carries live server state (draining, degraded), not only topology.

        ``wait_ack=False`` does not wait for the broker's PUBACK (a serving
        thread must not stall behind a slow broker).  ``require_connected``
        raises ``ConnectionError`` while the broker is unreachable; the
        merge still happens, and the reconnect's re-announce carries it."""
        client = self._client
        if client is None:
            return
        with self._lock:
            self.info.update(patch)
            payload = json.dumps(self.info).encode()
            if require_connected and not client.connected.is_set():
                raise ConnectionError(f"announce broker unreachable; {self.topic} update "
                                      "deferred to the reconnect re-announce")
            client.publish(self.topic, payload, retain=True, qos=1)
        if wait_ack and client.drain(5.0):
            self.log.warning("endpoint announce update on %s unacknowledged by the broker",
                             self.topic)

    def clear(self) -> None:
        """Delete the retained announce: late clients must not dial a port
        that was released."""
        client, self._client = self._client, None
        if client is None:
            return
        try:
            client.publish(self.topic, b"", retain=True, qos=1)
            if client.drain(5.0):
                self.log.warning("retained-announce delete on %s unacknowledged; a stale "
                                 "endpoint may remain on the broker", self.topic)
        except OSError:
            pass
        client.close()


def discover_endpoints(broker_host: str, broker_port: int, topic_filter: str, timeout_s: float,
                       settle_s: float = 0.25,
                       validate: Optional[Callable[[str, dict], bool]] = None,
                       logger=None, brokers: Optional[Iterable[Tuple[str, int]]] = None
                       ) -> Dict[str, Tuple[str, int]]:
    """The retained announces matching ``topic_filter`` (wildcards allowed)
    as ``{topic: (host, port)}``, empty when none (valid) came.

    Waits up to ``timeout_s`` for the first announce, then ``settle_s`` to
    gather the rest of a pod's retained set.  A deletion received meanwhile
    removes its entry; ``validate(topic, info)`` filters announces.
    ``brokers`` are standbys in failover order: one that refuses the dial,
    or dies before an announce came, hands the subscription to the next
    (the servers announce again into it).  Raises ``OSError`` when every
    broker refused."""
    lg = logger or log
    found: Dict[str, Tuple[str, int]] = {}
    lock = threading.Lock()

    def on_msg(topic: str, payload: bytes) -> None:
        if not payload:
            with lock:
                found.pop(topic, None)  # deleted: the server went away
            return
        try:
            info = json.loads(payload.decode())
            entry = (str(info["host"]), int(info["port"]))
        except (ValueError, KeyError, TypeError):
            lg.warning("undecodable announce on %s", topic)
            return
        if validate is not None and not validate(topic, info):
            return
        with lock:
            found[topic] = entry

    client = MqttClient(broker_host, broker_port, brokers=brokers)
    try:
        client.subscribe(topic_filter, on_msg, qos=0)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with lock:
                n = len(found)
            if n:
                time.sleep(settle_s)
                break
            time.sleep(0.01)
    finally:
        client.close()
    with lock:
        return dict(found)


def probe_endpoint(host: str, port: int, timeout_s: float = 0.5) -> bool:
    """True when ``host:port`` accepts a TCP connection."""
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True
    except OSError:
        return False
