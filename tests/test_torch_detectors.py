"""The port's detector stages (``ops/detectors.py``) against the JAX
package's on the CPU: every class on a table of cases (base64 payloads of
each magic-byte family, text in Latin and other scripts, phone numbers of
several regions, emails, URLs and maps of them), outputs equal value for
value (these are host string rules copied from the JAX package)."""
import base64

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from test_torch_text import JAX, PORT, assert_same_column, run_stage
from transmogrifai_tpu.ops import detectors as jdet
from transmogrifai_tpu_torch.ops import detectors as tdet


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


PAYLOADS = [
    _b64(b"%PDF-1.4 body"), _b64(b"\x89PNG\r\n\x1a\n" + bytes(20)),
    _b64(b"\xff\xd8\xff\xe0 jpeg"), _b64(b"GIF89a..."), _b64(b"PK\x03\x04z"),
    _b64(b"\x1f\x8b\x08gz"), _b64(b"<?xml version='1.0'?><a/>"),
    _b64(b"<!DOCTYPE html><html>"), _b64(b'{"a": 1}'),
    _b64("plain text é".encode()), _b64(b"\xfe\xfa\x00\x81binary"),
    "not base64 !!", "", None, _b64(b"RIFF....WAVE"),
    _b64(b"%PDF-1.7 " + bytes(3000))[:1500] + "\n" + "QUJD",
]

TEXTS = [
    "The cat is on the mat and it was happy", "Le chat est sur la table",
    "Der Hund und die Katze sind nicht hier", "El perro y el gato con la casa",
    "Il gatto è sul tavolo per la casa", "O gato não está em casa",
    "De kat is in het huis met een hond", "Привет как дела", "こんにちは世界",
    "你好世界", "안녕하세요", "שלום עולם", "مرحبا بالعالم", "नमस्ते दुनिया",
    "สวัสดีชาวโลก", "Γειά σου κόσμε", "the 東京 trip", "1234 5678", "", None,
    "xyzzy plugh",
]

PHONES = [
    "650-123-4567", "(415) 555 0199", "+1 415 555 0199", "1-650-123-4567",
    "+44 20 7946 0958", "020 7946 0958", "0049 30 123456", "123", "abc",
    "+12", "555-012-3456", "650-023-4567", None, "", "+33 1 23 45 67 89",
    "91 98765 43210",
]

REGIONS = ["1", "UNITED KINGDOM", "44", "germany", "India", "33", None,
           "Atlantis", "1", "1", "81", "52", "1", "1", "FRANCE", "91"]

EMAILS = ["a.b@example.com", "User+tag@Sub.Example.CO.uk", "bad@", "@x.com",
          "no-at-sign", "x@y", "first.last@dept.example.org", None, "",
          "a@b-.com", "ok_name@domain-with-dash.io"]

URLS = ["https://www.Example.com/path?q=1", "http://user:pw@host.org:8080/x",
        "ftp://files.example.net", "example.com/page", "//cdn.example.com/a",
        "not a url", "", None, "mailto:someone@example.com"]


def _maps(values, keys=("k1", "k2")):
    out = []
    for i in range(0, len(values), len(keys)):
        out.append({k: v for k, v in zip(keys, values[i:i + len(keys)])
                    if v is not None})
    return out + [None, {}]


CASES = [
    ("MimeTypeDetector", {}, "Base64", PAYLOADS),
    ("MimeTypeDetector", {"type_hint": "image/png"}, "Base64", PAYLOADS),
    ("MimeTypeDetector", {"max_bytes_to_parse": 2}, "Base64", PAYLOADS),
    ("MimeTypeMapDetector", {}, "Base64Map", _maps(PAYLOADS)),
    ("LangDetector", {}, "Text", TEXTS),
    ("ParsePhoneDefaultCountry", {}, "Phone", PHONES),
    ("ParsePhoneDefaultCountry", {"default_region": "44"}, "Phone", PHONES),
    ("ParsePhoneDefaultCountry", {"strict_validation": True}, "Phone",
     PHONES),
    ("IsValidPhoneDefaultCountry", {}, "Phone", PHONES),
    ("IsValidPhoneDefaultCountry", {"default_region": "GERMANY"}, "Phone",
     PHONES),
    ("IsValidPhoneMapDefaultCountry", {}, "PhoneMap", _maps(PHONES)),
    ("ValidEmailTransformer", {}, "Email", EMAILS),
    ("EmailToPickListMapTransformer", {}, "EmailMap", _maps(EMAILS)),
    ("UrlMapToPickListMapTransformer", {}, "URLMap", _maps(URLS)),
    ("FilterMap", {}, "TextMap", _maps(EMAILS, ("a", "b", "c"))),
    ("FilterMap", {"allow_keys": ["a", "b"], "block_keys": ["b"]},
     "TextMap", _maps(EMAILS, ("a", "b", "c"))),
    ("FilterMap", {"block_values": ["bad@", "x@y"]}, "EmailMap",
     _maps(EMAILS, ("a", "b", "c"))),
    ("NameEntityRecognizer", {}, "Text",
     ["Mary went to Paris with John Smith", "john smith", "Dr. Who", None,
      "", "Hiroshi Tanaka and Priya met Lucia"]),
]


@pytest.mark.parametrize("name,kw,tname,values", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_unary_detector_equal(name, kw, tname, values):
    specs = [(tname, "x")]
    _, (jo,) = run_stage(JAX, lambda: getattr(jdet, name)(**kw), specs,
                         [values])
    _, (to,) = run_stage(PORT, lambda: getattr(tdet, name)(**kw), specs,
                         [values])
    assert_same_column(to, jo)


@pytest.mark.parametrize("name,kw", [("ParsePhoneNumber", {}),
                                     ("ParsePhoneNumber",
                                      {"strict_validation": True}),
                                     ("IsValidPhoneNumber", {})])
def test_phone_with_region_equal(name, kw):
    specs = [("Phone", "p"), ("Text", "region")]
    raws = [PHONES, REGIONS]
    _, (jo,) = run_stage(JAX, lambda: getattr(jdet, name)(**kw), specs, raws)
    _, (to,) = run_stage(PORT, lambda: getattr(tdet, name)(**kw), specs,
                         raws)
    assert_same_column(to, jo)


@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_human_name_detector_equal(threshold):
    names = ["Mary Johnson", "John Smith", "Alan Turing", "data point",
             "Ingrid Bergman", None, "", "Some Long Sentence Here Today"]
    specs = [("Text", "who")]
    jm, (jo,) = run_stage(JAX, lambda: jdet.HumanNameDetector(threshold),
                          specs, [names])
    tm, (to,) = run_stage(PORT, lambda: tdet.HumanNameDetector(threshold),
                          specs, [names])
    assert tm.treat_as_name == jm.treat_as_name
    assert tm.metadata == jm.metadata
    assert_same_column(to, jo)


def test_country_codes_table_equal():
    assert tdet.DEFAULT_COUNTRY_CODES == jdet.DEFAULT_COUNTRY_CODES
    assert tdet._REGION_DIGITS == jdet._REGION_DIGITS
    assert tdet._MAGIC == jdet._MAGIC
    assert tdet._LANG_PROFILES == jdet._LANG_PROFILES
    assert tdet._FIRST_NAMES == jdet._FIRST_NAMES
    assert np.all([a == b for a, b in zip(tdet._SCRIPT_RANGES,
                                          jdet._SCRIPT_RANGES)])
