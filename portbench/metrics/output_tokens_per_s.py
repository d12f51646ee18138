"""output_tokens_per_s (tokens/s): every output token the window
emitted, over the window's seconds (host clock)."""


def read(record):
    serve = record.get("serve")
    if serve is None:
        return None
    return serve["output_tokens"] / record["window_s"]
