"""The PyTorch port's QCModel(device="cpu").run_file_device against the
reference package's run_file_device and run_file when the uniform proof
fails mid-file: the quality-error corpus of tests/test_device_qc_model.py
and the failures with chunks in flight of tests/test_ingest.py. The chunk
that fails and everything after it take the host route; the reports must
be equal (integers exact, floats to rel 1e-12).
"""

import pytest

from .test_torch_qc_model import FAILURE_CORPORA, check_corpus


@pytest.mark.parametrize("ref_entry", ["run_file", "run_file_device"])
@pytest.mark.parametrize("name", FAILURE_CORPORA)
def test_failure_report_matches_reference(tmp_path, name, ref_entry):
    check_corpus(tmp_path, name, ref_entry)
