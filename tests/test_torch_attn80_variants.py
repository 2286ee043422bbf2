"""The variants that ``tools/attn80_variants.py`` builds of the head-dim-80
attention kernels are text edits of ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu`` and ``csrc/hopper.cuh``: each must still find
the lines it replaces, so that an edit of the kernels cannot silently leave
the tool measuring something else.  The builds and timings themselves need
the card."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("attn80_variants",
                                               ROOT / "tools" / "attn80_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)
CSRC = ROOT / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_edits_apply(name):
    got = variants.texts(name)
    changed = [f for f in variants.SOURCES if got[f] != (CSRC / f).read_text()]
    if name == "default":
        assert changed == []
    else:
        assert changed, name
    # The entry points the tool calls stay in every variant.
    assert "repro_flash_attention_wgmma(" in got[variants.FWD]
    assert "repro_flash_attention_bwd_wgmma(" in got[variants.BWD]
    assert "repro_flash_attention_bwd_workspace(" in got[variants.BWD]


@pytest.mark.parametrize("name,source", [("fwd_stages3", variants.FWD),
                                         ("bwd_stages3", variants.BWD),
                                         ("narrow_first", "hopper.cuh"),
                                         ("bwd_interleave", variants.BWD),
                                         ("fwd_bk64", variants.FWD),
                                         ("fwd_no_pingpong", variants.FWD),
                                         ("bwd_sdp_one_group", variants.BWD),
                                         ("abl_no_turns", variants.BWD)])
def test_each_variant_edits_its_own_kernel(name, source):
    got = variants.texts(name)
    assert [f for f in variants.SOURCES if got[f] != (CSRC / f).read_text()] == [source]


def test_a_missing_line_is_refused():
    with pytest.raises(SystemExit, match="no line"):
        variants.kv.edited((variants.FWD,), [("no such line", "")], "attn80_variants")
