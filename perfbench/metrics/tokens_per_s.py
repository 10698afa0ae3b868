"""Output tokens delivered to clients (``on_token``) inside the window,
over the window's seconds."""


def read(run):
    return run.window_tokens / run.seconds
