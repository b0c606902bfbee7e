"""Web UI tests: dashboard, history detail, job lifecycle, file safety
(reference python/janusx/ui/server.py job/history views)."""

import json
import os
import time
import urllib.request
import urllib.parse

import pytest


@pytest.fixture()
def ui(tmp_path, monkeypatch):
    monkeypatch.setenv("JX_TPU_HISTORY_DB", str(tmp_path / "hist.db"))
    from janusx_tpu.ui.server import serve

    srv, state = serve(str(tmp_path), port=0)
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, state, tmp_path
    srv.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _post(url: str, data: dict, state=None):
    if state is not None:
        data = {**data, "csrf": state.csrf}
    body = urllib.parse.urlencode(data).encode()
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read().decode()


def test_dashboard_and_history(ui):
    base, state, tmp = ui
    from janusx_tpu.utils import history

    out = tmp / "res.tsv"
    out.write_text("chrom\tpos\tpwald\n1\t100\t0.5\n")
    history.record_run("gwas", str(tmp / "jx"), {"models": ["lmm"]},
                       [str(out)], 1.5)
    code, body = _get(base + "/")
    assert code == 200
    assert "gwas" in body and "Run history" in body
    code, body = _get(base + "/api/runs")
    runs = json.loads(body)
    assert len(runs) == 1 and runs[0][2] == "gwas"
    run_id = runs[0][0]
    code, body = _get(f"{base}/run/{run_id}")
    assert code == 200
    assert "res.tsv" in body and "pwald" in body  # TSV preview rendered


def test_job_submit_and_cancel(ui):
    base, state, tmp = ui
    # cross-origin-style POST without the token must be rejected
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/submit", {"module": "sim", "args": "-o x"})
    assert e.value.code == 403
    code, body = _post(base + "/submit", {"module": "sim", "args":
                                          "-nind 30 -nsnp 50 -o simout"},
                       state=state)
    assert code == 200  # after 303 redirect
    for _ in range(120):
        jobs = json.loads(_get(base + "/api/jobs")[1])
        if jobs and jobs[0]["status"] != "running":
            break
        time.sleep(0.5)
    assert jobs[0]["status"] == "ok", jobs
    code, body = _get(f"{base}/job/{jobs[0]['id']}")
    assert ".bed" in body or "sim" in body  # log tail rendered
    assert os.path.exists(tmp / "simout")


def test_submit_rejects_unknown_module(ui):
    base, state, tmp = ui
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/submit", {"module": "rm_rf", "args": "-x"}, state=state)
    assert e.value.code == 400


def test_file_access_restricted(ui):
    base, state, tmp = ui
    secret = "/etc/hostname"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + f"/file?p={urllib.parse.quote(secret)}")
    assert e.value.code == 403
    ok = tmp / "ok.txt"
    ok.write_text("fine")
    code, body = _get(base + f"/file?p={urllib.parse.quote(str(ok))}")
    assert code == 200 and body == "fine"


def test_render_sigsites_and_upload(ui):
    """Browser-driven GWAS views (reference /api/gwas-history render/
    sigsites and /api/gwas-upload): render a recorded run's assoc TSV,
    list its significant sites, and paste-upload an arbitrary TSV."""
    base, state, tmp = ui
    from janusx_tpu.utils import history

    tsv = tmp / "x.trait0.LM.assoc.tsv"
    rows = ["chrom\tpos\tsnp\taf\tbeta\tse\tpwald"]
    for i in range(50):
        p = 1e-8 if i == 7 else 0.3 + i * 0.01
        rows.append(f"1\t{100 + i}\ts{i}\t0.3\t0.1\t0.05\t{p}")
    tsv.write_text("\n".join(rows) + "\n")
    history.record_run("gwas", str(tmp / "x"), {}, [str(tsv)], 1.0)
    run_id = json.loads(_get(base + "/api/runs")[1])[0][0]

    code, body = _post(f"{base}/run/{run_id}/render", {}, state=state)
    assert code == 200 and "manhattan" in body
    assert os.path.exists(tmp / "x.trait0.LM.ui.manhattan.png")
    assert os.path.exists(tmp / "x.trait0.LM.ui.qq.png")

    code, body = _get(f"{base}/run/{run_id}/sigsites")
    assert code == 200 and "s7" in body and "1 sites" in body
    # p = 0.3 + i*0.01 for i != 7 -> 19 of those under 0.5, plus s7
    code, body = _get(f"{base}/run/{run_id}/sigsites?thr=0.5")
    assert "s7" in body and "20 sites" in body

    content = "\n".join(rows) + "\n"
    code, body = _post(base + "/upload",
                       {"name": "pasted", "content": content}, state=state)
    assert code == 200 and "lambda" in body.lower() or "λ" in body
    assert os.path.exists(tmp / "uploads" / "pasted.assoc.tsv")
    assert os.path.exists(tmp / "uploads" / "pasted.ui.manhattan.png")

    # malformed paste -> clean 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/upload", {"name": "bad", "content": "not a tsv"},
              state=state)
    assert e.value.code == 400
    # upload without the CSRF token is rejected
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/upload", {"name": "x", "content": content})
    assert e.value.code == 403


def test_second_device_job_waits_for_the_card(tmp_path, monkeypatch):
    """One job per card: with one card the second job queues until the
    first has ended, and each job is pinned to the card it runs on."""
    monkeypatch.setenv("JX_TPU_HISTORY_DB", str(tmp_path / "hist.db"))
    from janusx_tpu.ui.server import UiState

    state = UiState(str(tmp_path), cards=["0"])
    a = state.submit("grm", "-h")
    b = state.submit("grm", "-h")
    assert (a.status, b.status) == ("running", "queued")
    _wait_until(lambda: a.status != "running"
                and b.status not in ("queued", "running"))
    assert (a.status, b.status) == ("ok", "ok")
    assert b.launched >= a.finished
    c = state.submit("grm", "-h")
    d = state.submit("grm", "-h")
    state.cancel(d)  # a queued job is dropped, never launched
    assert d.status == "failed" and d.proc is None
    _wait_until(lambda: c.status != "running")
    assert c.status == "ok"


def _wait_until(done, tries: int = 240) -> None:
    for _ in range(tries):
        if done():
            return
        time.sleep(0.5)


@pytest.mark.parametrize("cards,module", [(["0"], "sim"), ([], "grm")])
def test_host_jobs_and_cardless_hosts_do_not_queue(tmp_path, monkeypatch,
                                                   cards, module):
    """A host-side module runs beside a device job on its card, and a host
    without cards starts every job at once, unpinned."""
    monkeypatch.setenv("JX_TPU_HISTORY_DB", str(tmp_path / "hist.db"))
    from janusx_tpu.ui.server import UiState

    state = UiState(str(tmp_path), cards=cards)
    jobs = [state.submit("grm", "-h"),
            state.submit(module, "-nind 30 -nsnp 50 -o a" if module == "sim"
                         else "-h")]
    assert [j.status for j in jobs] == ["running", "running"]
    _wait_until(lambda: all(j.status != "running" for j in jobs)
                and state._free == cards)
    assert [j.status for j in jobs] == ["ok", "ok"]
    assert state._free == cards


def test_job_that_cannot_start_frees_its_card(tmp_path, monkeypatch):
    """A launch failure marks the job failed and gives the card back, so
    the next device job still runs."""
    monkeypatch.setenv("JX_TPU_HISTORY_DB", str(tmp_path / "hist.db"))
    from janusx_tpu.ui import server

    def broken_popen(*a, **k):
        raise OSError("no such interpreter")

    state = server.UiState(str(tmp_path), cards=["0"])
    with monkeypatch.context() as m:
        m.setattr(server.subprocess, "Popen", broken_popen)
        bad = state.submit("grm", "-h")
    assert bad.status == "failed" and "no such interpreter" in bad.log_tail()
    assert state._free == ["0"]
    ok = state.submit("grm", "-h")
    _wait_until(lambda: ok.status != "running" and state._free == ["0"])
    assert ok.status == "ok" and state._free == ["0"]
