"""libaec_tpu_torch.cli against the JAX package's CLI on the same files.

tests/test_cli.py holds the JAX CLI against libaec's `aec` binary, which
is not built here; this twin runs both CLIs in subprocesses (the JAX one
with JAX_PLATFORMS=cpu) on its five CASES and compares the files, encode
and decode.  In process it drives the card routes of `_encode_to_file`
and `_decode_to_file` on CPU tensors (device="cpu", force_device=True;
decode once more with LIBAEC_TPU_FUSED_DECODE=1), the `-b` chunking, and
the routing: the size thresholds, the LIBAEC_TPU_ENCODE /
LIBAEC_TPU_DECODE knobs, and the exit status 1 that names the knob when
the card route is chosen on a host without a card
(torch.cuda.is_available patched to False).  Tolerance: byte equality.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402
from libaec_tpu import cli as jcli  # noqa: E402
from libaec_tpu_torch import cli, native  # noqa: E402
from libaec_tpu_torch.config import Config  # noqa: E402
from libaec_tpu_torch.constants import (  # noqa: E402
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
)

REPO = Path(__file__).resolve().parent.parent
CASES = [  # tests/test_cli.py's
    (["-n", "16", "-j", "64", "-r", "256", "-m"], 16, 0x0C),
    (["-n", "8", "-j", "16", "-r", "64"], 8, 0x08),
    (["-n", "32", "-j", "32", "-r", "32", "-m", "-s"], 32, 0x0D),
    (["-n", "24", "-j", "16", "-r", "16", "-3", "-m"], 24, 0x0E),
    (["-n", "4", "-j", "8", "-r", "16", "-t"], 4, 0x18),
]
IDS = ["16bit-msb", "8bit", "32bit-signed", "24bit-3byte", "4bit-restricted"]
KNOBS = ("LIBAEC_TPU_ENCODE", "LIBAEC_TPU_DECODE", "LIBAEC_TPU_FUSED_DECODE",
         "LIBAEC_TPU_PRINT_LAUNCHES")


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def case_config(flags, bps, cfg_flags):
    return Config(bps, int(flags[flags.index("-j") + 1]),
                  int(flags[flags.index("-r") + 1]), cfg_flags)


def source_file(tmp_path, cfg, seed):
    rng = np.random.default_rng(seed)
    n = cfg.samples_per_rsi * 5 + cfg.block_size * 3 + 1  # ragged tail
    vals = gen.gen_values(rng, n, cfg.bits_per_sample, cfg.signed,
                          "lowentropy")
    src = tmp_path / "src.dat"
    src.write_bytes(gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags))
    return src


def run_clis(jobs):
    """`python -m libaec_tpu_torch.cli` and `python -m libaec_tpu.cli`
    processes all at once: jobs are (module, arguments); each must exit
    0."""
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-m", mod, *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mod, args in jobs]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err


@pytest.mark.parametrize("flags,bps,cfg_flags", CASES, ids=IDS)
def test_cli_encode_decode_parity(tmp_path, flags, bps, cfg_flags):
    """Both CLIs give the same stream, the native encoder's, and decode it
    to the same file, the native decoder's (the four runs side by side:
    the decodes read the native encoder's stream)."""
    cfg = case_config(flags, bps, cfg_flags)
    src = source_file(tmp_path, cfg, bps)
    rz = tmp_path / "native.rz"
    rz.write_bytes(native.encode(src.read_bytes(), cfg)[1])
    jobs, outs = [], []
    for mod in ("libaec_tpu_torch.cli", "libaec_tpu.cli"):
        tag = mod.split(".")[0]
        enc, dec = tmp_path / f"{tag}.rz", tmp_path / f"{tag}.dat"
        jobs += [(mod, flags + [str(src), str(enc)]),
                 (mod, ["-d"] + flags + [str(rz), str(dec)])]
        outs.append((enc, dec))
    run_clis(jobs)
    (ours, ours_dec), (theirs, theirs_dec) = [
        (enc.read_bytes(), dec.read_bytes()) for enc, dec in outs]
    assert ours == theirs == rz.read_bytes()
    assert ours_dec == theirs_dec
    status, want = native.decode(ours, 2 * len(src.read_bytes()), cfg)
    assert status == 0 and ours_dec == want


@pytest.mark.parametrize("fused", [None, "1"], ids=["two-kernel", "fused"])
@pytest.mark.parametrize("flags,bps,cfg_flags", CASES, ids=IDS)
def test_card_routes_on_cpu_tensors(tmp_path, monkeypatch, flags, bps,
                                    cfg_flags, fused):
    """The card routes of encode and decode, run on CPU tensors, give the
    JAX CLI's files."""
    if fused:
        monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", fused)
    cfg = case_config(flags, bps, cfg_flags)
    data = source_file(tmp_path, cfg, bps + 1).read_bytes()
    routes = []
    for name in ("encode_buffer", "decode_buffer_device"):
        inner = getattr(cli, name)

        def spy(*args, _inner=inner, _name=name, **kwargs):
            routes.append(_name)
            return _inner(*args, **kwargs)
        monkeypatch.setattr(cli, name, spy)
    rz, dec = tmp_path / "ours.rz", tmp_path / "ours.dat"
    assert cli._encode_to_file(data, cfg, str(rz), device="cpu",
                               force_device=True) == 0
    comp = rz.read_bytes()
    assert cli._decode_to_file(comp, cfg, str(dec), device="cpu",
                               force_device=True) == 0
    assert routes == ["encode_buffer", "decode_buffer_device"]
    assert comp == jcli.encode_buffer(data, jcli.Config(
        bps, cfg.block_size, cfg.rsi, cfg_flags))
    jdec = tmp_path / "theirs.dat"
    assert jcli._decode_to_file(comp, jcli.Config(
        bps, cfg.block_size, cfg.rsi, cfg_flags), str(jdec)) == 0
    assert dec.read_bytes() == jdec.read_bytes()


@pytest.mark.parametrize("rsis_per_chunk", [1, 3, None])
def test_decode_chunked_native_loop(tmp_path, rsis_per_chunk):
    """_decode_to_file's native loop in chunks of whole RSIs gives the
    one-shot decode, as tests/test_streaming.py's test_cli_decode_chunked."""
    cfg = Config(16, 64, 16, 0x0C)
    rng = np.random.default_rng(6)
    vals = gen.gen_values(rng, 24 * cfg.samples_per_rsi + 100, 16, False,
                          "midentropy")
    data = gen.pack_samples(vals, 16, cfg.flags)
    enc = native.encode(data, cfg)[1]
    out = tmp_path / "out.dat"
    assert cli._decode_to_file(enc, cfg, str(out),
                               rsis_per_chunk=rsis_per_chunk) == 0
    assert out.read_bytes() == native.decode(enc, 2 * len(data), cfg)[1]


def test_cli_buffer_size_flag(tmp_path):
    """-b sizes the internal chunking (aec.c:149-156); the files are the
    same for any -b, and the JAX CLI's."""
    flags = ["-n", "16", "-j", "16", "-r", "32", "-m"]
    cfg = Config(16, 16, 32, 0x0C)
    src = source_file(tmp_path, cfg, 99)
    outs = []
    for b in ["64", "4096", "10485760"]:
        for mod, tag in ((cli, "ours"), (jcli, "theirs")):
            rz = tmp_path / f"{tag}{b}.rz"
            assert mod.main(flags + ["-b", b, str(src), str(rz)]) == 0
            dec = tmp_path / f"{tag}{b}.dat"
            assert mod.main(["-d"] + flags + ["-b", b, str(rz),
                                              str(dec)]) == 0
            outs.append((rz.read_bytes(), dec.read_bytes()))
    assert len(set(outs)) == 1


@pytest.mark.parametrize("argv", [["-x", "a", "b"], ["a"], ["-n"],
                                  ["-n", "40", "a", "b"]],
                         ids=["bad-option", "one-file", "no-files",
                              "bad-config"])
def test_cli_usage_errors(tmp_path, capsys, argv):
    assert cli.main(argv) == jcli.main(argv) == 1
    err = capsys.readouterr().err
    assert "SYNOPSIS" in err or "initialization failed" in err


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def bench_files(tmp_path):
    """A bench-config file, its stream, and the CLI flags."""
    flags = ["-n", "16", "-j", "64", "-r", "256", "-m"]
    cfg = case_config(flags, 16, 0x0C)
    src = source_file(tmp_path, cfg, 12)
    rz = tmp_path / "src.rz"
    rz.write_bytes(native.encode(src.read_bytes(), cfg)[1])
    return flags, cfg, src, rz


@pytest.mark.parametrize("direction,knob", [
    ("encode", ("LIBAEC_TPU_ENCODE", "jax")),
    ("decode", ("LIBAEC_TPU_DECODE", "device")),
    ("encode", None), ("decode", None)],
    ids=["encode-jax", "decode-device", "encode-auto", "decode-auto"])
def test_card_route_without_a_card_exits_1(tmp_path, monkeypatch, capsys,
                                           no_card, bench_files, direction,
                                           knob):
    """The card route on a host without a card: exit 1, the message names
    the knob that asks for the host, no file is written.  The route is
    chosen by the knob that drops the threshold, or by the size (the
    thresholds lowered to 0)."""
    flags, cfg, src, rz = bench_files
    if knob:
        monkeypatch.setenv(*knob)
    else:
        monkeypatch.setattr(cli, "AUTO_JAX_MIN_BYTES", 0)
        monkeypatch.setattr(cli, "DEVICE_DECODE_MIN_BYTES", 0)
    out = tmp_path / "out"
    args = flags + [str(src), str(out)] if direction == "encode" \
        else ["-d"] + flags + [str(rz), str(out)]
    assert cli.main(args) == 1
    want = "LIBAEC_TPU_ENCODE=native" if direction == "encode" \
        else "LIBAEC_TPU_DECODE=cpu"
    assert want in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("knob", [("LIBAEC_TPU_ENCODE", "native"),
                                  ("LIBAEC_TPU_ENCODE", "numpy"),
                                  ("LIBAEC_TPU_DECODE", "cpu")],
                         ids=["encode-native", "encode-numpy", "decode-cpu"])
def test_host_knobs_need_no_card(tmp_path, monkeypatch, no_card,
                                 bench_files, knob):
    """The JAX package's knobs that ask for the host keep every size off
    the card (the thresholds lowered to 0), with the JAX CLI's bytes."""
    flags, cfg, src, rz = bench_files
    monkeypatch.setenv(*knob)
    monkeypatch.setattr(cli, "AUTO_JAX_MIN_BYTES", 0)
    monkeypatch.setattr(cli, "DEVICE_DECODE_MIN_BYTES", 0)
    for mod, tag in ((cli, "ours"), (jcli, "theirs")):
        out = tmp_path / tag
        if knob[0] == "LIBAEC_TPU_ENCODE":
            assert mod.main(flags + [str(src), str(out)]) == 0
        else:
            assert mod.main(["-d"] + flags + [str(rz), str(out)]) == 0
    assert (tmp_path / "ours").read_bytes() == \
        (tmp_path / "theirs").read_bytes()


def test_routing_by_size_and_gate(tmp_path, monkeypatch, bench_files):
    """Below the thresholds, and outside the kernel gates at any size,
    the CLI runs natively; at or above them inside the gates it takes the
    card route (here spied, on CPU tensors)."""
    flags, cfg, src, rz = bench_files
    calls = []
    monkeypatch.setattr(cli, "encode_buffer", lambda *a, **k: (
        calls.append("encode_buffer"), b"")[1])
    monkeypatch.setattr(cli, "decode_buffer_device", lambda *a, **k: (
        calls.append("decode_buffer_device"), (0, b""))[1])
    data, comp = src.read_bytes(), rz.read_bytes()
    out = str(tmp_path / "out")
    assert cli._encode_to_file(data, cfg, out, device="cpu") == 0
    assert cli._decode_to_file(comp, cfg, out, device="cpu") == 0
    assert calls == []
    monkeypatch.setattr(cli, "AUTO_JAX_MIN_BYTES", len(data))
    monkeypatch.setattr(cli, "DEVICE_DECODE_MIN_BYTES",
                        (-(-len(data) // cfg.rsi_len_bytes)) *
                        cfg.rsi_len_bytes)
    assert cli._encode_to_file(data, cfg, out, device="cpu") == 0
    assert cli._decode_to_file(comp, cfg, out, device="cpu") == 0
    assert calls == ["encode_buffer", "decode_buffer_device"]
    del calls[:]
    # AEC_PAD_RSI lies outside the encode gate only; bs 128 outside both
    pad = Config(16, 64, 256, cfg.flags | AEC_PAD_RSI)
    big = Config(16, 128, 16, cfg.flags | AEC_NOT_ENFORCE)
    for c, want in ((pad, ["decode_buffer_device"]), (big, [])):
        st, stream_c = native.encode(data, c)
        assert cli._encode_to_file(data, c, out, device="cpu",
                                   force_device=True) == 0
        assert Path(out).read_bytes() == stream_c
        assert cli._decode_to_file(stream_c, c, out, device="cpu",
                                   force_device=True) == 0
        assert calls == want
        del calls[:]


def test_launch_counts_on_request(tmp_path, monkeypatch, capsys,
                                  bench_files):
    flags, cfg, src, rz = bench_files
    out = str(tmp_path / "out")
    assert cli.main(flags + [str(src), out]) == 0
    assert "launches" not in capsys.readouterr().err
    monkeypatch.setenv("LIBAEC_TPU_PRINT_LAUNCHES", "1")
    assert cli.main(["-d"] + flags + [str(rz), out]) == 0
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith("launches ")
    counts = json.loads(line[len("launches "):])
    assert counts == cli.launch_counts()
    assert set(counts) == {"encode_fields", "merge_windows", "decode_blocks",
                           "unpredict_swizzle", "unpredict_rsis",
                           "samples_to_bytes", "decode_fused"}
