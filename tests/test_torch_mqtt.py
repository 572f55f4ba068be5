"""The port's MQTT client (runtime/mqtt_client.py) against an in-process
fake paho client: tests/test_mqtt.py's cases on the port's module, and the
same script of calls through both packages' Mqtt, whose fake clients must
record the same calls.

Reference semantics (sources/network/mqtt.cpp): own worker thread, bounded
outbound queue with silent drop when full (mqtt.cpp:52-74), QoS-2
subscriptions replayed on (re)connect (mqtt.cpp:111-126), topic-callback
dispatch, reconnect retry loop, clean shutdown.
"""

import json
import sys
import threading
import time

import pytest

import rtl_sdr_scanner_tpu.runtime.mqtt_client as jmc
import rtl_sdr_scanner_tpu_torch.runtime.mqtt_client as tmc
from tests.test_mqtt import FakePahoClient, _install_fake_paho, _wait


def test_url_parsing():
    assert tmc._parse_url("tcp://broker:1883") == ("broker", 1883, False)
    assert tmc._parse_url("ssl://broker:8883") == ("broker", 8883, True)
    assert tmc._parse_url("mqtts://broker") == ("broker", 8883, True)
    assert tmc._parse_url("broker") == ("broker", 1883, False)
    assert tmc._parse_url("broker:1234") == ("broker", 1234, False)


def test_publish_subscribe_dispatch(monkeypatch):
    _install_fake_paho(monkeypatch)
    m = tmc.Mqtt("ssl://broker.example:8883", "user", "secret", client_id="t1")
    client = FakePahoClient.instances[-1]
    assert _wait(lambda: client.loop_running)
    assert client.connects == [("broker.example", 8883, 60)]
    assert client.tls and client.username == "user"

    received = []
    m.set_message_callback("sdr/list", received.append)
    m.publish("sdr/x/transmission/uint8", b"\x01\x02", qos=0)
    m.publish("sdr/x/spectrogram", "text-payload")
    assert _wait(lambda: len(client.published) == 2)
    assert client.published[0] == ("sdr/x/transmission/uint8", b"\x01\x02", 0)
    assert client.published[1][1] == b"text-payload"
    # QoS-2 subscription (mqtt.cpp:124)
    assert ("sdr/list", 2) in client.subscribed

    client.deliver("sdr/list", b"{}")
    client.deliver("sdr/other", b"ignored")
    assert received == ["{}"]
    m.stop()
    assert client.disconnected and not client.loop_running


def test_queue_bounded_silent_drop(monkeypatch):
    """mqtt.cpp:52-74: outbound queue caps at 1000, overflow drops silently."""
    _install_fake_paho(monkeypatch)
    client_holder = {}

    class SlowClient(FakePahoClient):
        def connect(self, host, port, keepalive=60):
            client_holder["ready"] = True
            time.sleep(0.5)
            super().connect(host, port, keepalive)

    sys.modules["paho.mqtt.client"].Client = SlowClient
    m = tmc.Mqtt("tcp://broker:1883", "u", "p")
    assert _wait(lambda: client_holder.get("ready"))
    for _ in range(tmc.QUEUE_MAX_SIZE + 250):
        m.publish("t", b"x")
    assert m._queue.qsize() <= tmc.QUEUE_MAX_SIZE + 1  # bounded, no exception
    client = FakePahoClient.instances[-1]
    assert _wait(lambda: len(client.published) >= tmc.QUEUE_MAX_SIZE, timeout=10)
    m.stop()
    assert len(client.published) <= tmc.QUEUE_MAX_SIZE + 1


def test_reconnect_retry_and_resubscribe(monkeypatch):
    """Connect failures retry (mqtt.cpp:30-38); subscriptions replay on the
    eventual connect (mqtt.cpp:111-126). The waits are test_mqtt.py's."""
    _install_fake_paho(monkeypatch)
    monkeypatch.setattr(tmc, "RECONNECT_INTERVAL_S", 0.05)

    class FlakyClient(FakePahoClient):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.connect_failures = 2

        def subscribe(self, topic, qos=0):
            if not self.connects:
                raise RuntimeError("not connected")
            super().subscribe(topic, qos)

    sys.modules["paho.mqtt.client"].Client = FlakyClient
    m = tmc.Mqtt("tcp://broker:1883", "u", "p")
    m.set_message_callback("sdr/config/abc", lambda s: None)  # pre-connect
    client = FakePahoClient.instances[-1]
    assert _wait(lambda: client.loop_running, timeout=10)
    assert client.connect_failures == 0  # retried through both failures
    assert ("sdr/config/abc", 2) in client.subscribed  # resubscribed on connect
    m.stop()


def test_tls_ca_file_from_config(monkeypatch, tmp_path):
    """A private-CA broker needs its bundle passed through (the reference
    pins the system store path, mqtt.cpp:81-83)."""
    _install_fake_paho(monkeypatch)
    m = tmc.Mqtt("ssl://broker:8883", "u", "p", ca_file="/etc/private/ca.pem")
    client = FakePahoClient.instances[-1]
    assert client.tls and client.ca_certs == "/etc/private/ca.pem"
    m.stop()

    # default: system store (ca_certs=None)
    m = tmc.Mqtt("ssl://broker:8883", "u", "p")
    client = FakePahoClient.instances[-1]
    assert client.tls and client.ca_certs is None
    m.stop()

    # wired through the port's Config: env tier + JSON "mqtt" section
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config, default_config_json

    raw = default_config_json()
    raw["mqtt"] = {"ca_file": "/from/json/ca.pem"}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    monkeypatch.setenv("MQTT_URL", "ssl://broker:8883")
    monkeypatch.delenv("MQTT_CA_FILE", raising=False)
    cfg = Config.load_from_file(str(path), scan_hardware=False)
    assert cfg.mqtt_ca_file == "/from/json/ca.pem"
    monkeypatch.setenv("MQTT_CA_FILE", "/from/env/ca.pem")
    cfg = Config.load_from_file(str(path), scan_hardware=False)
    assert cfg.mqtt_ca_file == "/from/env/ca.pem"
    m = tmc.make_mqtt(cfg)
    client = FakePahoClient.instances[-1]
    assert client.ca_certs == "/from/env/ca.pem"
    m.stop()


def test_dropped_connection_redelivers_subscriptions(monkeypatch):
    """A mid-session broker drop re-delivers every subscription when the
    transport reconnects (mqtt.cpp:111-126): paho's network loop re-fires
    on_connect after an automatic reconnect."""
    _install_fake_paho(monkeypatch)
    m = tmc.Mqtt("tcp://broker:1883", "u", "p")
    client = FakePahoClient.instances[-1]
    assert _wait(lambda: client.loop_running)
    received = []
    m.set_message_callback("sdr/list", received.append)
    m.set_message_callback("sdr/config/abc", received.append)
    assert _wait(lambda: ("sdr/config/abc", 2) in client.subscribed)

    client.subscribed.clear()
    client.on_connect(client, None, None, 0)
    assert ("sdr/list", 2) in client.subscribed
    assert ("sdr/config/abc", 2) in client.subscribed
    client.deliver("sdr/list", b"{}")
    assert received == ["{}"]
    m.stop()


def test_make_mqtt_falls_back_without_env(monkeypatch):
    class Cfg:
        mqtt_enabled = False
        mqtt_url = ""
        mqtt_username = ""
        mqtt_password = ""

    assert isinstance(tmc.make_mqtt(Cfg()), tmc.NullMqtt)


class _GatedClient(FakePahoClient):
    """A fake whose connect waits for the test's word, so that the calls
    before it (a pre-connect subscribe, queued publishes) land in one order
    in every run."""

    gate = threading.Event()

    def connect(self, host, port, keepalive=60):
        assert self.gate.wait(timeout=10), "the test never let the client connect"
        super().connect(host, port, keepalive)


def _script(module, monkeypatch):
    """One script of calls through ``module``'s Mqtt on a fresh fake: a
    pre-connect subscribe, publishes of bytes and str, the connect, a
    delivery to the subscribed topic and one to another, then stop. Returns
    the fake's recorded calls and the callback's arguments."""
    _install_fake_paho(monkeypatch)
    _GatedClient.gate = threading.Event()
    sys.modules["paho.mqtt.client"].Client = _GatedClient
    m = module.Mqtt("ssl://broker.example:8883", "user", "secret", client_id="parity", ca_file="/ca.pem")
    client = FakePahoClient.instances[-1]
    received = []
    m.set_message_callback("sdr/list", received.append)  # before the connect
    m.publish("sdr/x/transmission/uint8", b"\x01\x02\xff", qos=0)
    m.publish("sdr/x/spectrogram", "text-payload", qos=2)
    _GatedClient.gate.set()
    assert _wait(lambda: client.loop_running and len(client.published) == 2)
    client.deliver("sdr/list", b'{"a": 1}')
    client.deliver("sdr/other", b"ignored")
    m.stop()
    assert not m._thread.is_alive()
    recorded = {key: getattr(client, key) for key in (
        "client_id", "clean_session", "username", "password", "tls", "ca_certs", "connects", "published",
        "subscribed", "loop_running", "disconnected")}
    return recorded, received


def test_client_records_the_same_calls_as_the_jax_package(monkeypatch):
    """The same script through both packages' Mqtt: the fake clients record
    equal calls (connect, TLS and credentials, publishes as bytes with their
    QoS, the pre-connect subscribe and its replay on connect, loop and
    disconnect) and the callbacks get equal arguments."""
    want = _script(jmc, monkeypatch)
    got = _script(tmc, monkeypatch)
    assert got == want
    recorded, received = got
    assert recorded["subscribed"] == [("sdr/list", 2), ("sdr/list", 2)]  # at the call, then on connect
    assert received == ['{"a": 1}']
    assert (tmc.QUEUE_MAX_SIZE, tmc.RECONNECT_INTERVAL_S, tmc.QOS_SUB) == (
        jmc.QUEUE_MAX_SIZE, jmc.RECONNECT_INTERVAL_S, jmc.QOS_SUB)


URLS = ("tcp://broker:1883", "ssl://broker:8883", "mqtts://broker", "ssl://broker", "broker", "broker:1234",
        "tcp://broker", "mqtts://10.0.0.2:9001", "ws://broker:80", "", "tcp://broker:", "tcp://broker:port",
        "broker:12:34", "[::1]:1883", " broker", "tcp://broker ")


@pytest.mark.parametrize("url", URLS)
def test_parse_url_matches_the_jax_package(url):
    """The same URLs parse equal through both _parse_urls, and those that
    raise raise the same error."""
    def parse(module):
        try:
            return module._parse_url(url)
        except Exception as exc:  # compared below: the same type and message
            return type(exc), str(exc)

    assert parse(tmc) == parse(jmc)
