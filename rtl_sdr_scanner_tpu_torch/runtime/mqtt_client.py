"""MQTT client (host side).

Reference: sources/network/mqtt.cpp -- own thread, bounded (1000) outbound
queue with silent drop when full, topic-callback dispatch, 5 s auto-reconnect
with resubscribe (QoS 2 subscriptions).

paho-mqtt is optional in this environment; when missing (or no MQTT_URL is
configured) a NullMqtt stands in so the scan pipeline runs headless.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

from rtl_sdr_scanner_tpu_torch.utils import logger

LABEL = "mqtt"
QUEUE_MAX_SIZE = 1000
RECONNECT_INTERVAL_S = 5.0
QOS_SUB = 2


class NullMqtt:
    """No-broker stand-in: records callbacks, counts drops; publish is a
    no-op. Lets the whole runtime run offline/replay without a broker."""

    def __init__(self):
        self.published: List[Tuple[str, bytes]] = []
        self.keep_payloads = False
        self._callbacks: List[Tuple[str, Callable[[str], None]]] = []

    def publish(self, topic: str, payload: Union[bytes, str], qos: int = 0) -> None:
        if self.keep_payloads:
            data = payload.encode() if isinstance(payload, str) else bytes(payload)
            self.published.append((topic, data))

    def set_message_callback(self, topic: str, callback: Callable[[str], None]) -> None:
        self._callbacks.append((topic, callback))

    def inject(self, topic: str, payload: str) -> None:
        """Test hook: deliver a message as if from the broker."""
        for t, cb in self._callbacks:
            if t == topic:
                cb(payload)

    def stop(self) -> None:
        pass


class Mqtt:
    """paho-mqtt wrapper with the reference's threading/queueing shape."""

    def __init__(
        self,
        url: str,
        username: str,
        password: str,
        client_id: str = "sdr-scanner",
        ca_file: str = "",
    ):
        import paho.mqtt.client as paho  # gated import

        self._queue: "queue.Queue[Tuple[str, bytes, int]]" = queue.Queue()
        self._callbacks: List[Tuple[str, Callable[[str], None]]] = []
        self._topics: set = set()
        self._running = True

        host, port, use_tls = _parse_url(url)
        self._client = paho.Client(client_id=client_id, clean_session=True)
        self._client.username_pw_set(username, password)
        if use_tls:
            # ca_file: private-CA bundle from config/env (MQTT_CA_FILE);
            # None = system CA store (the reference pins /etc/ssl/certs,
            # mqtt.cpp:82-83, which IS the system store on its image)
            self._client.tls_set(ca_certs=ca_file or None)
        self._client.on_message = self._on_message
        self._client.on_connect = self._on_connect
        self._host, self._port = host, port
        self._thread = threading.Thread(target=self._worker, name="mqtt", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        logger.info(LABEL, "started")
        while self._running:
            try:
                self._client.connect(self._host, self._port, keepalive=60)
                break
            except OSError:
                logger.info(LABEL, "reconnecting...")
                time.sleep(RECONNECT_INTERVAL_S)
        self._client.loop_start()
        while self._running:
            try:
                topic, payload, qos = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._client.publish(topic, payload, qos=qos)
            except Exception as exc:
                logger.warn(LABEL, "publish exception: {}", exc)
        self._client.loop_stop()
        self._client.disconnect()
        logger.info(LABEL, "stopped")

    def _on_connect(self, client, userdata, flags, rc) -> None:
        logger.info(LABEL, "connected")
        for topic in self._topics:
            client.subscribe(topic, QOS_SUB)

    def _on_message(self, client, userdata, message) -> None:
        for topic, callback in self._callbacks:
            if topic == message.topic:
                try:
                    callback(message.payload.decode())
                except Exception as exc:
                    logger.warn(LABEL, "callback exception: {}", exc)

    def publish(self, topic: str, payload: Union[bytes, str], qos: int = 0) -> None:
        """Bounded enqueue, silent drop when full (mqtt.cpp:52-74)."""
        if self._queue.qsize() < QUEUE_MAX_SIZE:
            data = payload.encode() if isinstance(payload, str) else bytes(payload)
            self._queue.put((topic, data, qos))

    def set_message_callback(self, topic: str, callback: Callable[[str], None]) -> None:
        self._callbacks.append((topic, callback))
        self._topics.add(topic)
        try:
            self._client.subscribe(topic, QOS_SUB)
        except Exception:
            pass  # resubscribed on (re)connect

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=5)


def _parse_url(url: str) -> Tuple[str, int, bool]:
    """ssl://host:port, tcp://host:port, or bare host[:port]."""
    use_tls = url.startswith("ssl://") or url.startswith("mqtts://")
    stripped = url.split("://", 1)[-1]
    if ":" in stripped:
        host, port_s = stripped.rsplit(":", 1)
        return host, int(port_s), use_tls
    return stripped, 8883 if use_tls else 1883, use_tls


def make_mqtt(config) -> Union[Mqtt, NullMqtt]:
    """Factory honoring env-configured secrets; NullMqtt when unconfigured or
    paho is unavailable."""
    if not config.mqtt_enabled:
        logger.info(LABEL, "MQTT_URL not set, running without broker")
        return NullMqtt()
    try:
        return Mqtt(
            config.mqtt_url,
            config.mqtt_username,
            config.mqtt_password,
            ca_file=getattr(config, "mqtt_ca_file", ""),
        )
    except ImportError:
        logger.warn(LABEL, "paho-mqtt unavailable, running without broker")
        return NullMqtt()
