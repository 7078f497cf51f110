"""Mean device-idle ms a frame while the host is innermost in
`render_video`'s host work: the rays (`video.rays`), their copy
(`upload`), the reads of colour and depth (`video.to_host`), the depth
panel (`video.panel`) and `to8b` (`video.to8b`)."""
from gpu_bench.program_spans import idle_ms

HOST_WORK = ("video.rays", "upload", "video.to_host", "video.panel",
             "video.to8b")


def read(ctx):
    return idle_ms(ctx, "video", HOST_WORK)
