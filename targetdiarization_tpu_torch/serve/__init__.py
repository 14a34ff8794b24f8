"""Serving: the REST and WebSocket API (`server.py`) and its browser page
(`webui.py`). Import `server` for `build_model`, `create_app` and
`run_server`; the app needs aiohttp, the model does not."""
