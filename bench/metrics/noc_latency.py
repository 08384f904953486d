"""noc_latency: mean cycles a NoC packet takes in the queued replay
(``NoCStats.avg_latency``), mean over the answers of the cell's first
``quality_jobs`` jobs.  Nothing to read where the NoC count is analytic."""


def read(ctx):
    answers = [a for j in ctx.quality_jobs for a in j["answers"]
               if a["platform"]["noc_mode"] == "queued"]
    if not answers:
        return None
    return sum(float(a["noc"]["avg_latency"]) for a in answers) / len(answers)
