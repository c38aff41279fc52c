"""Mode `se`: single-end reads of any length through the port's
UnpairedAligner on one card (`submit` takes a list of SeqRecord; reads
past the rectangle buckets take the long-read host path)."""

PAIRED = False


def aligner(data, policy, device, chips):
    from bowtie2_tpu_torch.pipeline.align import UnpairedAligner

    if chips != 1:
        raise ValueError("mode se runs on one card")
    return UnpairedAligner(data, policy, device=device)


def records(units, names):
    """The port's records of a batch of reads (codes, quals, ...)."""
    from bowtie2_tpu_torch.io.fastx import SeqRecord

    return [SeqRecord(name=n, seq=u[0], qual=u[1])
            for u, n in zip(units, names)]
