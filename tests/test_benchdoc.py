"""Generated-docs sync gate: docs/api.md is rendered from the live
docstrings, and this test fails whenever it drifts from them."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "docs"))


def test_api_reference_in_sync():
    import gen_api

    md = gen_api.render()
    assert open(gen_api.API_MD).read() == md, (
        "docs/api.md does not match the live docstrings — run "
        "`python docs/gen_api.py` and commit the result")
