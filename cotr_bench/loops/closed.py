"""A closed loop with one caller: each request goes out when the last one
has come back. The window opens at the first request and closes at the end
of the first request that finishes after ``seconds``, so only whole
requests count; it ends in a synchronize of the card."""

import time


def window(driver, seconds: float, sync) -> dict:
    attempted = answers = 0
    t_start = time.perf_counter()
    while True:
        answers += driver.request(attempted)
        attempted += 1
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    return {"attempted": attempted, "answers": answers,
            "window_s": time.perf_counter() - t_start}
