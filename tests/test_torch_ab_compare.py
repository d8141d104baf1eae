"""The parent-against-change timing script (``utils/ab_compare.py``) reads
``chip_smoke.py``'s phase-2 lines, request lines and peak-memory lines; on
the CPU only its parser runs (the runs need a card)."""

from tooncrafter_tpu_torch.utils import ab_compare

LOG = """\
== build 12.3 s
_flash_mh_packed ds1 B=32 S=2560 C=320: max_abs_err=9.648e-04 (bound 3.906e-03) mean_abs_err=5.680e-05 (bound 1.465e-04, |ref| mean 2.599e-02 max 3.540e-01) ms=0.9823 plain_ms=27.2417 library_ms=0.6211 bound_ms=0.2714 (operations) ok
_pallas_ff ds1 N=81920 C=320 D=1280 LN+residual: max_abs_err=3.077e-02 (bound 6.250e-02) mean_abs_err=1.885e-03 (bound 5.422e-03, |ref| max 6.671e+00) ms=1.1910 plain_ms=7.4036 chain_ms=1.3406 library_ms=none bound_ms=0.2036 (operations) ok
== requests inference_512_v1.0.yaml
request 0 (fs 24): 13.74 s; phase seconds encode 0.26
request 1 (fs 24): 13.59 s; phase seconds encode 0.19
peak memory allocated 13.29 GiB; kernel launches {}
== requests inference_1024_v1.0.yaml
request 0 (fs 24): 48.37 s; phase seconds encode 0.58
peak memory allocated 35.01 GiB; kernel launches {}
"""


def test_parse_reads_kernel_times_requests_and_peaks():
    got = ab_compare.parse(LOG)
    assert got["kernels"] == {
        "_flash_mh_packed ds1 B=32 S=2560 C=320": {
            "ms": 0.9823, "bound_ms": 0.2714, "library_ms": 0.6211},
        "_pallas_ff ds1 N=81920 C=320 D=1280 LN+residual": {
            "ms": 1.191, "bound_ms": 0.2036, "library_ms": None}}
    assert got["requests"] == {"inference_512_v1.0.yaml": [13.74, 13.59],
                               "inference_1024_v1.0.yaml": [48.37]}
    assert got["peak_gib"] == {"inference_512_v1.0.yaml": 13.29,
                               "inference_1024_v1.0.yaml": 35.01}


def test_a_run_whose_kernels_fail_their_check_ends_non_zero(tmp_path):
    """A checkout whose ``chip_smoke.check_kernels`` exits (a kernel off
    its plain version) ends its run there: a non-zero code and no request
    answered, so the comparison reports no times from it."""
    utils = tmp_path / "tooncrafter_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    for d in (utils.parent, utils):
        (d / "__init__.py").write_text("")
    (utils / "kernel_check.py").write_text("def build_all():\n    pass\n")
    (tmp_path / "chip_smoke.py").write_text(
        "KERNELS_512 = KERNELS_1024 = ()\n"
        "def check_kernels(dev):\n"
        "    print(LINE)\n"
        "    raise SystemExit('kernels disagree with their plain versions')\n"
        "def answer_requests(*a):\n"
        "    print('request 0 (fs 24): 1.00 s')\n"
        f"LINE = {LOG.splitlines()[1]!r}\n")
    run = ab_compare.run_one(str(tmp_path), str(tmp_path / "run.log"))
    assert run["rc"] != 0
    assert run["requests"] == {}
    assert "kernels disagree" in (tmp_path / "run.log").read_text()


def test_parse_reads_training_steps_and_their_peak():
    """4b's lines (``chip_smoke.train_full_width``) go under 'training',
    beside the requests; the request peaks stay each model's own. The
    backward's phase-2 line, which names each gradient, is read too."""
    log = LOG + (
        "_flash_bwd_bh ds1 B=32 S=2560 C=320 heads=5: dq max_abs_err=2.8e-03 "
        "(bound 1.6e-02) mean_abs_err=5.9e-05 (bound 1.5e-04, |ref| max "
        "5.5e-01); dk max_abs_err=2.1e-03 (bound 1.6e-02); ms=1.9513 "
        "plain_ms=37.3456 library_ms=1.9145 bound_ms=0.6786 (operations) ok\n"
        "== training\n"
        "train step 0: 2.98 s, loss 0.125000, grad_norm 1.0, t 500; "
        "launches _flash_bwd_bh 15\n"
        "train step 1: 1.62 s, loss 0.120000, grad_norm 1.0, t 400; "
        "launches _flash_bwd_bh 15\n"
        "training: peak memory allocated 43.73 GiB; 10 of 10 trainable "
        "tensors got a non-zero gradient; EMA shadow moved on 10 of 10\n")
    got = ab_compare.parse(log)
    assert got["kernels"]["_flash_bwd_bh ds1 B=32 S=2560 C=320 heads=5"] == {
        "ms": 1.9513, "bound_ms": 0.6786, "library_ms": 1.9145}
    assert got["requests"]["training"] == [2.98, 1.62]
    assert got["peak_gib"] == {"inference_512_v1.0.yaml": 13.29,
                               "inference_1024_v1.0.yaml": 35.01,
                               "training": 43.73}
