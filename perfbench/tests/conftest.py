import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def small_sample(monkeypatch):
    """The smoke runs serve a few dozen tokens a request: the check's
    sample asks for 12 served tokens, not the cells' 512."""
    from perfbench import check
    monkeypatch.setattr(check, "SAMPLE_TOKENS", 12)
