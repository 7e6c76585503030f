"""mqttsink / mqttsrc: tensor streams over MQTT pub/sub.

Port of ``nnstreamer_tpu/elements/mqtt.py`` (≙ the reference's
``gst/mqtt/`` and ``Documentation/synchronization-in-mqtt-elements.md``):
the sink stamps its pipeline's base time as an epoch in every message; the
source shifts incoming pts into its own clock (``pts += sender_base_epoch
- receiver_base_epoch``), so pipelines on several devices stay aligned
without a shared clock.  ``ntp-sync=false`` sends a base epoch of 0, and
receivers then keep the sender's pts.

A message is a 24-byte header (8-byte magic ``NNSMQTT1``, f64 base epoch,
f64 sent epoch, big-endian) and one frame in the ``idl`` codec (``flex``,
the wire frame of ``distributed/wire.py``; ``protobuf``; ``flatbuf``):
the JAX package's bytes.  The transport is ``distributed/mqtt.py``;
``qos=1`` is at-least-once across broker restarts.

The sink never hands a card tensor to a transport thread: on its render
thread a frame comes to the host (a micro-batch with one copy per tensor)
before it is encoded.
"""

from __future__ import annotations

import logging
import queue as _queue
import struct
import threading
import time
from typing import Iterator, Optional

from ..core.buffer import BatchFrame, TensorFrame
from ..core.lifecycle import pipeline_quiescing
from ..core.resilience import FAULTS
from ..core.types import ANY, StreamSpec
from ..distributed import wire
from ..distributed.mqtt import MqttClient
from ..pipeline.element import ElementError, Property, SinkElement, SourceElement, element

_HDR = struct.Struct(">8sdd")  # magic, base epoch, sent epoch
_MAGIC = b"NNSMQTT1"


def _ref_alias(el, canonical: str, reference: str):
    """A reference-spelled alias (``cleansession``) wins when set explicitly,
    else its canonical property (``clean-session``) applies."""
    return el.props[reference] if reference in el._explicit_props else el.props[canonical]


def _effective_qos(el) -> int:
    """``mqtt-qos`` (the reference's name) when set (>= 0), else ``qos``."""
    mq = el.props.get("mqtt-qos", -1)
    return mq if mq >= 0 else el.props["qos"]


def _apply_debug(el) -> None:
    """``debug=true`` logs verbosely for this run; an explicit ``silent=``
    wins."""
    if "silent" not in el._explicit_props:
        el.log.setLevel(logging.DEBUG if el.props["debug"] else logging.NOTSET)


_COMMON = {
    "host": Property(str, "127.0.0.1", "broker host"),
    "port": Property(int, 1883, "broker port"),
    "client-id": Property(str, "", "MQTT client id (auto if empty)"),
    "idl": Property(str, "flex", "payload IDL: flex | protobuf | flatbuf (interop)"),
    "mqtt-qos": Property(int, -1, "alias of qos (reference name; -1 = unset)"),
    "clean-session": Property(bool, True, "false = persistent session"),
    "cleansession": Property(bool, True, "alias of clean-session (reference name)"),
    "keep-alive-interval": Property(int, 60, "MQTT keepalive, seconds"),
    "debug": Property(bool, False, "verbose logging (≙ reference debug)"),
}


@element("mqttsink")
class MqttSink(SinkElement):
    BATCH_AWARE = True  # a micro-batch comes to the host in one copy per tensor

    PROPERTIES = {
        **_COMMON,
        "pub-topic": Property(str, "", "topic to publish to (required)"),
        "retain": Property(bool, False, "retain the last message"),
        "num-buffers": Property(int, -1, "stop after N messages (-1 = all)"),
        # ≙ reference mqtt_qos (gst/mqtt/mqttsink.h:77)
        "qos": Property(int, 0, "MQTT QoS: 0 (fire-forget) | 1 (at-least-once)"),
        # publishers reconnect later than subscribers, so that after a
        # broker restart the subscriptions are back before redelivery
        "reconnect-delay": Property(float, 1.0, "initial reconnect backoff, s"),
        "max-buffer-size": Property(
            int, 0, "max encoded message bytes (0 = unlimited; larger drops with a warning)"),
        "ntp-sync": Property(
            bool, True, "stamp the base-epoch header for cross-device pts rebasing (clock "
            "assumed NTP/chrony-disciplined; ≙ mqttsink ntp-sync)"),
        "ntp-srvs": Property(
            str, "", "NTP servers (recorded; time discipline is the fleet's, not per-element)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._client: Optional[MqttClient] = None
        self._base_epoch = 0.0
        self._sent = 0
        self._encode = wire.encode_frame

    def start(self) -> None:
        if not self.props["pub-topic"]:
            raise ElementError(f"{self.name}: pub-topic is required")
        _apply_debug(self)
        try:
            self._encode, _ = wire.get_codec(self.props["idl"])
        except wire.WireError as e:
            raise ElementError(f"{self.name}: {e}") from None
        self._client = MqttClient(
            self.props["host"], self.props["port"], client_id=self.props["client-id"],
            keepalive=self.props["keep-alive-interval"],
            clean_session=_ref_alias(self, "clean-session", "cleansession"),
            reconnect_delay_s=self.props["reconnect-delay"])
        self._base_epoch = time.time() if self.props["ntp-sync"] else 0.0
        self._sent = 0

    def stop(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            # at-least-once: a bounded wait for parked QoS-1 publishes
            left = client.drain(5.0)
            if left:
                self.log.warning("stopping with %d unacknowledged QoS-1 publish(es)", left)
            client.close()

    def render(self, frame: TensorFrame) -> None:
        frame = frame.to_host()
        for f in frame.split() if isinstance(frame, BatchFrame) else (frame,):
            self._publish(f)

    def _publish(self, frame: TensorFrame) -> None:
        limit = self.props["num-buffers"]
        if self._client is None or 0 <= limit <= self._sent:
            return
        payload = _HDR.pack(_MAGIC, self._base_epoch, time.time()) + self._encode(frame)
        if FAULTS.is_armed():
            # corrupt= faults mutate the message after its checksum: the
            # subscriber's verify must catch and drop it
            payload = FAULTS.mangle("mqtt.publish", payload)
        cap = self.props["max-buffer-size"]
        if cap and len(payload) > cap:
            self.log.warning("message %d bytes exceeds max-buffer-size %d (dropped)",
                             len(payload), cap)
            return
        self._client.publish(self.props["pub-topic"], payload, retain=self.props["retain"],
                             qos=_effective_qos(self))
        self._sent += 1


@element("mqttsrc")
class MqttSrc(SourceElement):
    PROPERTIES = {
        **_COMMON,
        "sub-topic": Property(str, "", "topic filter (+/# wildcards ok)"),
        "num-buffers": Property(int, -1, "EOS after N messages (-1 = forever)"),
        "sub-timeout": Property(int, 10000, "ms without a message before EOS"),
        "max-msg-buf-size": Property(int, 64, "receive queue depth"),
        "reconnect-delay": Property(float, 0.1, "initial reconnect backoff, s"),
        # pair qos=1 with clean-session=false and a stable client-id for no
        # loss across subscriber restarts
        "qos": Property(int, 0, "subscription QoS: 0 | 1 (at-least-once)"),
        "is-live": Property(
            bool, True, "live source semantics (a broker feed is always live; false is "
            "accepted for reference parity and ignored)"),
        "verify-checksum": Property(
            bool, True, "verify wire integrity checksums on received frames (v2 envelopes); "
            "corrupt messages are dropped and counted in health()"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._decode = wire.decode_frame
        self._client: Optional[MqttClient] = None
        self._q: "_queue.Queue[bytes]" = _queue.Queue(64)
        self._base_epoch = 0.0
        self._stopping = threading.Event()
        self._corrupt_dropped = 0
        self._dropped_full = 0

    def output_spec(self) -> StreamSpec:
        return ANY

    def start(self) -> None:
        if not self.props["sub-topic"]:
            raise ElementError(f"{self.name}: sub-topic is required")
        self._stopping = threading.Event()  # restartable
        _apply_debug(self)
        try:
            _, self._decode = wire.get_codec(self.props["idl"])
        except wire.WireError as e:
            raise ElementError(f"{self.name}: {e}") from None
        self._q = _queue.Queue(self.props["max-msg-buf-size"])
        self._client = MqttClient(
            self.props["host"], self.props["port"], client_id=self.props["client-id"],
            keepalive=self.props["keep-alive-interval"],
            reconnect_delay_s=self.props["reconnect-delay"],
            clean_session=_ref_alias(self, "clean-session", "cleansession"))
        self._base_epoch = time.time()
        self._client.subscribe(self.props["sub-topic"], self._on_message,
                               qos=min(1, max(0, _effective_qos(self))))

    def stop(self) -> None:
        self._stopping.set()  # ends frames() at its next wait slice
        client, self._client = self._client, None
        if client is not None:
            client.close()

    def _on_message(self, topic: str, payload: bytes) -> None:
        try:
            self._q.put(payload, timeout=1.0)
        except _queue.Full:
            # the client has acknowledged it already: at qos=1 this is a
            # loss, counted so that a run can prove it had none
            self._dropped_full += 1
            self.log.warning("receive queue full; dropping message")

    def health_info(self) -> dict:
        return {"corrupt_dropped": self._corrupt_dropped, "dropped_full": self._dropped_full}

    def _next_payload(self, timeout_s: float) -> Optional[bytes]:
        """The next message, or None at stop, drain or ``sub-timeout``
        (bounded wait slices, so a stop ends the stream at once)."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self._stopping.is_set() or pipeline_quiescing(self):
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.log.info("sub-timeout reached; ending stream")
                return None
            try:
                return self._q.get(timeout=min(0.25, remaining))
            except _queue.Empty:
                continue

    def frames(self) -> Iterator[TensorFrame]:
        limit = self.props["num-buffers"]
        n = 0
        while limit < 0 or n < limit:
            payload = self._next_payload(self.props["sub-timeout"] / 1000.0)
            if payload is None:
                return
            if len(payload) < _HDR.size or payload[:8] != _MAGIC:
                self._corrupt_dropped += 1
                self.log.warning("MQTT message without the %r header dropped", _MAGIC)
                continue
            _, base_epoch, sent_epoch = _HDR.unpack_from(payload, 0)
            try:
                frame = self._decode(payload[_HDR.size:], verify=self.props["verify-checksum"])
            except wire.WireError as e:
                self._corrupt_dropped += 1
                self.log.warning("undecodable MQTT frame dropped: %s", e)
                continue
            # the sender's stream clock shifted into ours; base epoch 0 =
            # the sender has no shared epoch (ntp-sync=false)
            if frame.pts is not None and base_epoch > 0.0:
                frame.pts += base_epoch - self._base_epoch
            frame.meta["mqtt-sent-epoch"] = sent_epoch
            frame.meta["mqtt-latency-s"] = max(0.0, time.time() - sent_epoch)
            n += 1
            yield frame
