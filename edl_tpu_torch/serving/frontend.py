"""HTTP frontend for a serving replica: ``POST /predict`` (batch
replicas), ``POST /generate`` (LM replicas), plus the full obs surface
(`/metrics`, `/healthz`, `/spans`) on one port. A copy of
`edl_tpu.serving.frontend`.

Extends the obs plane's request handler rather than growing a web
framework: the serving endpoints are one ``do_POST`` on top of the same
`ThreadingHTTPServer` the obs plane runs for scrapes, so one port
per replica serves both traffic and telemetry — exactly what the
autoscaler needs (it scrapes the same address it routes to).

Request wire format (JSON):

    {"features": {"x": [[...13 floats...]]}}        -> one request row
    {"features": [{...}, {...}]}                    -> N independent rows

    {"prompt": [1, 5, 9], "max_new_tokens": 16,     -> one LM stream
     "eos_id": 2}                                      (only prompt req'd)

Each row/stream is submitted to the replica's continuous-batching engine
separately — the server-side batcher, not the client, decides batch
composition (that is the entire point of continuous batching). LM
admission errors map to the HTTP contract: a prompt+budget the seq-bucket
ladder can never hold is 400 (retrying cannot help), an exhausted KV
block pool is 429 (retry elsewhere or later).
"""

from __future__ import annotations

import json
from typing import Optional

from edl_tpu_torch.obs.http import MetricsServer, ObsRequestHandler
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.obs.tracing import Tracer

__all__ = ["ServeRequestHandler", "make_frontend"]


def _to_jsonable(row):
    import numpy as np

    if hasattr(row, "tolist"):
        return row.tolist()
    if isinstance(row, dict):
        return {k: _to_jsonable(v) for k, v in row.items()}
    if isinstance(row, (list, tuple)):
        return [_to_jsonable(v) for v in row]
    if isinstance(row, (np.floating, np.integer)):
        return row.item()
    return row


class ServeRequestHandler(ObsRequestHandler):
    server_version = "edl-serve/1"

    replica = None  # type: ignore[assignment]  # set via handler_attrs

    def do_POST(self) -> None:  # noqa: N802 (stdlib handler contract)
        from edl_tpu_torch.serving.worker import ServeOverloadError

        path = self.path.split("?", 1)[0]
        if path not in ("/predict", "/generate"):
            self.send_error(404, "try POST /predict or /generate")
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError):
            self.send_error(400, "body must be JSON")
            return
        if path == "/generate":
            self._handle_generate(payload)
            return
        features = payload.get("features")
        if features is None:
            self.send_error(400, 'missing "features"')
            return
        rows = features if isinstance(features, list) else [features]
        replica = self.replica
        try:
            futures = [replica.submit(row) for row in rows]
            outputs = [f.result(timeout=replica.config.request_timeout_s)
                       for f in futures]
        except ServeOverloadError as e:
            self.send_error(429, str(e))
            return
        except (KeyError, ValueError, TypeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        except Exception as e:  # edl: noqa[EDL005] surfaced to the caller as HTTP 500 — a failed batch fails the request loudly instead of killing the server thread
            self.send_error(500, f"prediction failed: {type(e).__name__}: {e}")
            return
        status = replica.status()
        body = {
            "outputs": [_to_jsonable(row) for row in outputs],
            "model_step": status["model_step"],
            "version": status["version"],
        }
        if not isinstance(features, list):
            body["outputs"] = body["outputs"][0]
        self._reply(json.dumps(body).encode(), "application/json")

    def _handle_generate(self, payload) -> None:
        from edl_tpu_torch.serving.batcher import SeqTooLongError
        from edl_tpu_torch.serving.kvcache import KVCacheExhaustedError

        replica = self.replica
        if not hasattr(replica, "generate"):
            self.send_error(404, "this replica serves /predict, not LM "
                                 "generation")
            return
        prompt = payload.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            self.send_error(400, '"prompt" must be a non-empty token-id list')
            return
        try:
            result = replica.generate(
                prompt,
                max_new_tokens=payload.get("max_new_tokens"),
                eos_id=payload.get("eos_id"),
            )
        except KVCacheExhaustedError as e:
            self.send_error(429, str(e))
            return
        except SeqTooLongError as e:
            self.send_error(400, str(e))
            return
        except (KeyError, ValueError, TypeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        except Exception as e:  # edl: noqa[EDL005] surfaced to the caller as HTTP 500 — a failed stream fails the request loudly instead of killing the server thread
            self.send_error(500, f"generation failed: {type(e).__name__}: {e}")
            return
        self._reply(json.dumps(result).encode(), "application/json")


def make_frontend(replica, port: int = 0,
                  registry: Optional[MetricsRegistry] = None,
                  tracer: Optional[Tracer] = None) -> MetricsServer:
    """Start the replica's HTTP frontend: `/predict` + obs endpoints."""
    server = MetricsServer(
        registry=registry, tracer=tracer, port=port,
        health=replica._health,
        handler_cls=ServeRequestHandler,
        handler_attrs={"replica": replica},
    )
    return server.start()
