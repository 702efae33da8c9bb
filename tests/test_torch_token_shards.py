"""The LM's token shards in the port against the JAX package's: packs
byte-identical from one generated corpus, each side reading the other's,
the refusals letter for letter, the packer CLI against
tools/make_token_shards.py, the loader's int32 batches and padded eval
tail, and the exact-resume cursor with its dataset identity."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port_util import reset_port_cfg

from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.data.shards import tokens as jtok
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.shards import format as tformat
from distribuuuu_tpu_torch.data.shards import pack_tokens
from distribuuuu_tpu_torch.data.shards import tokens as ttok
from distribuuuu_tpu_torch.data.shards.reader import ShardDataset

PACK = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("the quick brown fox jumps over a lazy dog while seven small birds sing "
         "near old stone walls and rivers run past quiet hills").split()


def _docs(n=40, seed=0):
    """Seeded word salad: ``n`` documents of 10-60 words."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(10, 60)))).encode() for _ in range(n)]


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


def _pack(mod, root, docs, pack_len=PACK, target_bytes=4096):
    return mod.write_token_shards(str(root), mod.pack_token_stream(docs, pack_len), pack_len,
                                  target_bytes=target_bytes, source="corpus")


def _files(split_dir):
    return {f: open(os.path.join(split_dir, f), "rb").read() for f in sorted(os.listdir(split_dir))}


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """The same corpus packed by the port (``port/train``) and by JAX
    (``jax/train``), several shards each."""
    root = tmp_path_factory.mktemp("tok")
    docs = _docs()
    for name, mod in (("port", ttok), ("jax", jtok)):
        _pack(mod, root / name / "train", docs)
    return root


def test_packs_are_byte_identical(packs):
    port, jax_ = _files(packs / "port" / "train"), _files(packs / "jax" / "train")
    assert sorted(port) == sorted(jax_) and len(port) > 3  # several shards
    for f in port:
        assert port[f] == jax_[f], f
    man = json.loads(port[tformat.MANIFEST_NAME])
    assert man["kind"] == "tokens" and man["pack_len"] == PACK
    assert man["total_tokens"] == man["num_records"] * (PACK + 1)
    assert man["tokenizer"] == "byte-v1"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_side_reads_the_other_pack(packs, writer):
    t = ttok.TokenShardDataset(str(packs / writer), "train", PACK, 320)
    j = jtok.TokenShardDataset(str(packs / writer), "train", PACK, 320)
    assert len(t) == len(j) > 10
    assert t.identity() == j.identity()
    for i in (0, 1, len(t) // 2, len(t) - 1):
        np.testing.assert_array_equal(t.seq_tokens(i), j.seq_tokens(i))
        for a, b in zip(t[i], j[i]):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t[i][0][1:], t[i][1][:-1])  # the next-token shift


def _refusal(mod, *args, **kw):
    with pytest.raises(Exception) as e:
        mod.TokenShardDataset(*args, **kw)
    return type(e.value).__name__, str(e.value)


def test_refusals_match_jax_letter_for_letter(packs, tmp_path):
    root = str(packs / "port")
    cases = [(root, "train", PACK * 2, 320), (root, "train", PACK, 256)]
    drift = tmp_path / "drift" / "train"
    os.makedirs(drift)
    for f, data in _files(packs / "port" / "train").items():
        (drift / f).write_bytes(data)
    man = json.loads((drift / tformat.MANIFEST_NAME).read_text())
    man["tokenizer"] = "byte-v0"
    (drift / tformat.MANIFEST_NAME).write_text(json.dumps(man))
    cases.append((str(tmp_path / "drift"), "train", PACK, 320))
    for args in cases:
        got = _refusal(ttok, *args)
        assert got == _refusal(jtok, *args)
        assert got[0] == "ShardFormatError"
    for mod in (ttok, jtok):
        with pytest.raises(ValueError, match="0 complete records") as e:
            _pack(mod, tmp_path / mod.__name__.split(".")[0] / "train", [b"hi"])
        assert "pack_len=32" in str(e.value)


def test_species_guards(packs, tmp_path):
    """The image reader refuses a token pack; the token reader an image one."""
    with pytest.raises(tformat.ShardFormatError, match="'tokens' shards"):
        ShardDataset(str(packs / "port"), "train", 32, train=True)
    w = tformat.ShardWriter(str(tmp_path / "img" / "train"), target_bytes=1 << 20)
    w.add(b"\xff\xd8", 0, "a.jpg")
    tformat.write_shard_manifest(str(tmp_path / "img" / "train"), w.close(), classes=["a"],
                                 target_bytes=1 << 20)
    with pytest.raises(tformat.ShardFormatError, match="'images' shards"):
        ttok.TokenShardDataset(str(tmp_path / "img"), "train", PACK)


def _cli_lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_packer_cli_matches_the_tool(tmp_path, capsys):
    """``pack_tokens`` and tools/make_token_shards.py on one corpus file:
    the same shard bytes and manifests, the same JSON lines (but the
    manifest path), the same verify lines and exit codes."""
    src = tmp_path / "corpus.txt"
    src.write_bytes(b"\n\n".join(_docs(60, seed=3)))
    args = ["--src", str(src), "--pack-len", str(PACK), "--shard-mb", "0.004",
            "--val-frac", "0.1"]
    assert pack_tokens.main([*args, "--out", str(tmp_path / "p")]) == 0
    port_lines = _cli_lines(capsys.readouterr().out)
    tool = [sys.executable, os.path.join(REPO, "tools", "make_token_shards.py")]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([*tool, *args, "--out", str(tmp_path / "j")], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    jax_lines = _cli_lines(res.stdout)
    for a, b in zip(port_lines, jax_lines, strict=True):
        assert {**a, "manifest": ""} == {**b, "manifest": ""}
    for split in ("train", "val"):
        assert _files(tmp_path / "p" / split) == _files(tmp_path / "j" / split)
    assert pack_tokens.main(["--out", str(tmp_path / "p"), "--verify"]) == 0
    ok_lines = _cli_lines(capsys.readouterr().out)
    assert [x["ok"] for x in ok_lines] == [True, True]
    shard = sorted(f for f in os.listdir(tmp_path / "p" / "train") if f.endswith(".drec"))
    path = tmp_path / "p" / "train" / shard[0]
    data = bytearray(path.read_bytes())
    data[20] ^= 0xFF
    path.write_bytes(bytes(data))
    assert pack_tokens.main(["--out", str(tmp_path / "p"), "--verify"]) == 1
    out = capsys.readouterr().out
    assert "VERIFY FAILED" in out
    res = subprocess.run([*tool, "--out", str(tmp_path / "p"), "--verify"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 1
    assert [{**x, "seconds": 0} for x in _cli_lines(res.stdout)] == \
        [{**x, "seconds": 0} for x in _cli_lines(out)]


def _token_cfg(root, batch):
    tcfg.merge_from_list(["DATA.FORMAT", "tokens", "LM.SEQ_LEN", PACK, "MODEL.NUM_CLASSES",
                          320, "TRAIN.DATASET", str(root), "TEST.DATASET", str(root),
                          "TEST.SPLIT", "train", "TRAIN.BATCH_SIZE", batch,
                          "TEST.BATCH_SIZE", batch, "TRAIN.WORKERS", 1])


def test_loader_batches_int32_and_pads_the_eval_tail(packs):
    _token_cfg(packs / "port", 4)
    train = tloader.construct_train_loader()
    train.set_epoch(0)
    b = next(iter(train))
    assert b["image"].shape == b["label"].shape == (4, PACK)
    assert b["image"].dtype == b["label"].dtype == np.int32
    np.testing.assert_array_equal(b["image"][:, 1:], b["label"][:, :-1])
    val = tloader.construct_val_loader()
    n = len(val.dataset)
    tcfg.TEST.BATCH_SIZE = n + 3  # one ragged batch: n records and 3 pads
    val = tloader.construct_val_loader()
    (tail,) = list(val)
    assert tail["image"].shape == tail["label"].shape == (n + 3, PACK)
    assert tail["label"].dtype == np.int32
    assert tail["mask"].tolist() == [1.0] * n + [0.0] * 3
    assert not tail["label"][n:].any()
    np.testing.assert_array_equal(tail["label"][0], val.dataset[0][1])


def test_cursor_round_trips_and_refuses_identity_drift(packs):
    _token_cfg(packs / "port", 1)
    loader = tloader.construct_train_loader()
    assert loader.can_save_state()
    loader.set_epoch(2)
    full = [b["image"].copy() for b in loader]
    sd = json.loads(json.dumps(loader.state_dict(3)))  # through JSON, as saved
    assert sd["dataset_identity"] == {"kind": "tokens", "pack_len": PACK,
                                      "tokenizer": "byte-v1", "vocab_size": 320, "eos_id": 256}
    fresh = tloader.construct_train_loader()
    assert fresh.load_state_dict(sd) == 3
    fresh.set_epoch(2)
    resumed = [b["image"].copy() for b in fresh]
    assert len(resumed) == len(full) - 3
    for a, b in zip(resumed, full[3:]):
        np.testing.assert_array_equal(a, b)
    drifted = {**sd, "dataset_identity": {**sd["dataset_identity"], "pack_len": PACK * 2}}
    with pytest.raises(ValueError, match="dataset identity changed") as e:
        tloader.construct_train_loader().load_state_dict(drifted)
    # JAX's loader refuses with the same words
    from distribuuuu_tpu.data import construct_train_loader as jax_train_loader

    saved = jcfg.clone()
    try:
        jcfg.merge_from_list(["DATA.FORMAT", "tokens", "LM.SEQ_LEN", PACK,
                              "MODEL.NUM_CLASSES", 320, "TRAIN.DATASET", str(packs / "port"),
                              "TRAIN.BATCH_SIZE", 1])
        jl = jax_train_loader()
        jsd = {**jl.state_dict(3), "dataset_identity": drifted["dataset_identity"]}
        with pytest.raises(ValueError, match="dataset identity changed") as je:
            jl.load_state_dict(jsd)
    finally:
        jcfg.merge_from_other_cfg(saved)
    assert str(e.value) == str(je.value)
